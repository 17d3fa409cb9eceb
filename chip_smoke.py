#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one card: the rootless collectives, the
dense serving path, the paged serving path, the training step,
speculative decoding, mixture-of-experts layers, tensor-, expert- and
sequence-parallel inference, pipeline-parallel training with a resume
from a checkpoint, the consensus-gated bridge with its
multi-process deployment and engine tracing, sequence-, tensor- and
expert-parallel training as processes on the card, the rootless
serving fabric over fleets of the card's DecodeServers, the host
facades (native, loopback, mpi, tcp) fed card tensors, and the
developer tools (the static analyzers, the byte pinning, the hostile
probes of the decode kernels, rlo-scope and rlo-trace), the
collectives' backward (K1 with a backward, every differentiable
collective and ``forward``'s gradient under a manual tp schedule as
processes on the card), every kernel past CUDA's 65,535 blocks on
grid.y/z, and TP/EP generation and the pipelines as processes on the
card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero
without them, and without the ``rlo_tpu_torch`` package beside it. Runs
on one card: with several visible it pins itself to the first.
Phases, each printing its own lines:

1. Card: the count of cards ``nvidia-smi -L`` lists (before the pin),
   ``nvidia-smi`` name and power limit, torch and CUDA versions;
   builds every kernel of the port from ``rlo_tpu_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together); the SASS of the
   flash library must hold HMMA (tensor-core) instructions in every bf16
   instantiation of K2-K5 and none in the f32 ones, and more in each bf16
   K4/K5 than in K3 at the same head dim (their products moved too).
2. K1 (the fused combine) against its plain PyTorch version on the card:
   f32/bf16 x sum/min/max, int32 x sum/min/max/and/or, with NaN inputs,
   int32 values above 2^24, ragged and unaligned sizes, sizes at the
   edges of the unrolled loop's block step and past its grid's cap, the
   in-place accumulate, and the shapes of the main path. Results must be
   bit-identical to the plain version's (NaN payloads included). Times the
   kernel and ``torch.add(out=)`` at 256 MB and 32 MB (a ring chunk) fp32
   by events, by device time (the profiler) and by host time, and the
   plain version by events.
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
   contiguous copies. K6 and K9 split the cache axis at ``SPLIT_K`` and
   merge in the launch: each is held against its twin at ``SPLIT_K``, row
   t of a T = 4 call must equal a T = 1 call at pos + t bit for bit (rows
   across split edges), 50 repeat launches the first launch's bits, q
   read from the projection's view its contiguous copy's bits; they and
   ``scaled_dot_product_attention`` are timed by events and by device
   time (the profiler), and the window that times K6 or K9 must hold one
   launch of its kernel a call and nothing else (its count and the
   profiler). K2 is timed at the prefill shape, the training
   shape and on its f32 route, in turns with
   ``scaled_dot_product_attention``. Then K9 (paged decode) at the paged
   decode shape (289 permuted pages of 128), a prefill chunk, GQA group 4
   and pages
   of 256, and on pages holding a dense cache's columns, where it must
   equal K6 bit for bit; K10 and K11 (page writes) bit-identical,
   sentinels included. K7, K8, K10 and K11 also from the projection's
   views (16-byte loads along hd, at hd 16-128; and one element off:
   scalar loads; K7 and K10 also at hd 1, K10 two rows on one page) and
   in the pair form
   (k with v, the int8 scale pair): bit-identical, one launch a pair (the
   wrapper's count), 50 repeat launches the same bits, and the callers'
   k/v write runs that kernel and no copy (the profiler). Times each
   kernel, its plain version, its bound and one PyTorch call that
   computes the same function (K9: K6 on the equivalent dense cache
   instead; no single call pages); the writes also by device time (the
   profiler) and by host time, K7, K8, K10 and K11 from the path's own
   views, with their k/v pair against two sliced or indexed assignments
   (``time_k7``, ``time_k8``, ``time_k10``, ``time_k11``).
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
   each kernel by events and by device time, its plain version, its
   bound and (K4, K5) the backward of ``scaled_dot_product_attention``
   at the same shape (its device time, by the profiler: timed by events,
   the call is bound by the host).
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
11. Speculative decoding at full width: the flagship target with
   spec_bench's draft (d 512, 8 heads, 2 layers, d_ff 2048, bf16),
   batch 8, plen 256, 64 new tokens, gamma 4, with the random draft,
   the target itself and the target plus seeded noise: greedy tokens
   equal ``generate``'s up to a near-tie; the self-draft takes
   ceil(63 / 4) rounds unless a near-tie parted draft and verify (each
   parting at one); tokens per round and ms per emitted token beside
   ``generate``'s. K6, K7 and K8's launch counts are set to 0 just
   before the three runs and read just after.
12. MoE at full width: the flagship's widths with 8 experts. Training
   on 4 x 1024 as phase 9 (loss and grads against 'xla' mode, 10 SGD
   steps falling, aux finite and > 0, the share of tokens dropped, the
   step with the sorted dispatch forced beside it); serving drop-free
   (capacity factor 8): ``generate`` at batch 32 / plen 1024 / 16 new
   against the argmax of a teacher-forced ``forward``, a 16-request
   ``DecodeServer`` against each prompt's own ``generate``, and 16
   teacher-forced ``paged_decode_step``s beside ``decode_step``. K2,
   K4-K10's launch counts are set to 0 before this phase and read after.
13. Tensor-, expert- and sequence-parallel inference at full width,
   each rank a thread of a ``LocalMesh`` on the one card, the params cut
   by ``param_pspecs``/``shard_tree``: (a) TP ``generate`` (tp 4, the
   flagship at batch 32 / plen 1024 / 8 new, bf16) against the one-rank
   generate by the near-tie rule, and GQA+RoPE ``decode_step`` and T = 4
   ``block_decode`` at tp 2 with a bf16 and an int8 cache, logits within
   PAR_REL_BF16 of one rank's; (b) the TP forward (tp 4, ring allreduce:
   K1) on 4 x 1024, logits within PAR_REL_BF16; (c) EP ``generate`` at
   phase 12's widths (ep 4, 2 experts and 8 rows a rank, drop-free,
   plen 1024, 8 new) with the 'xla' and 'direct' all_to_alls, which
   must give the same tokens bit for bit, each row held against the
   one-rank generate with both runs' router records (``routes_against``:
   router log-probabilities within ROUTER_TOL up to the row's first
   routing difference, which must sit at a router near-tie, and a
   parting with no routing difference before it at a logit near-tie);
   in f32 every row equal to the end, in bf16 at least half (a router
   near-tie sends a token to another expert where two bf16 runs round
   another way; the partings are printed with their gaps); (d) the SP
   forward of one 4096-token sequence over sp 4: ring
   contiguous, ring striped and Ulysses, bf16 within PAR_REL_BF16 and
   f32 within PAR_REL_F32 of one rank's forward, K2 launched sp steps x
   layers x ranks times for the ring. Every rank holds the same bits
   where it must (TP logits and tokens); each path runs once inside a
   profiled window: its wall time, device time, peak memory and
   launches of K1, K2 and K6-K8 (set to 0 just before the path and read
   just after).
14. Pipeline-parallel training at full width: the flagship config,
   one batch of 8 x 1024 from the seed, the stages threads of a
   ``LocalMesh`` on the one card cut by ``pipeline_pspecs``/
   ``shard_tree``: (a) the GPipe step at pp 4 (2 layers a stage) in 8
   microbatches and (b) the 1F1B step on the same mesh, each against
   the single-card ``train_step`` on the same batch (loss within
   PIPE_LOSS_RTOL, the update new - old within DP_REL_LIMIT per tensor)
   and 1F1B against GPipe; (c) each rank's ``ppermute`` calls equal
   ``pipeline_cost``'s (GPipe 2 x 11 x 1, 1F1B 14 x 2), the 1F1B ring
   holds ``peak_boundary_blocks`` (7) saved inputs, GPipe's most stage
   graphs held at once, each schedule's peak device memory; (d) both
   schedules at (dp 2, pp 2) in 4 microbatches against the single card;
   (e) three 1F1B steps at pp 2 straight, and the first step saved
   (gathered) by ``CheckpointManager``, restored onto the card into a
   fresh pp-2 layout and the last two run again: losses and params
   bit-identical; (f) K2, K4 and K5's launch counts set to 0 before the
   phase and read after, and per pipelined step; (g) the median wall
   per step of each schedule beside the single-card step (rank threads
   on one card: not a figure for pipelining across cards).
15. The consensus-gated bridge and several processes on the card:
   (a) ``rlo_tpu_torch.init(backend="hybrid", world_size=8)`` with 256
   MB fp32 a rank (the gate: the C engines' judged round, as the JAX
   package's bridge): gated allreduce (ring), reduce_scatter and all_gather
   from proposer 5, bit-identical to the ungated ``TorchBackend`` calls;
   a shape and a dtype veto (decision 0, and their profiled windows hold
   no kernel at all); ``device_judge`` vetoes from a NaN in rank 6's
   tensor and in the proposer's own; the wall time of a gated and an
   ungated allreduce and the host time of one consensus round at ws 8
   and of one judged round on the C engines and on the Python engines;
   K1's launch count set to 0 before the phase and read after it. (b)
   four processes on the one card, each a ``MultiHostContext`` (engine
   over the TCP transport, data group gloo, local tensors and judges on
   the card), run the multihost demo's rounds 1-4 and each prints
   ``MULTIHOST-OK``. (c) The gated rounds of (a) run inside
   ``utils.tracing.annotate``: the profiler window records the range with
   every K1 kernel inside it; one gated round's C-engine events (the C
   core's trace ring) equal the same round's on the CPU.
16. Sequence-, tensor- and expert-parallel training at full width as
   four processes on the one card (``chip_smoke.py
   --train-parallel-worker``), each one rank over gloo (``DistAxis`` on
   ``dist_mesh_axes``: params, activations and kernels on the card, the
   collectives staged through host buffers), one SGD step on phase 9's
   4 x 1024 batch: (a) sp 4 ring, (b) sp 4 Ulysses, (c) tp 4, (d) sp 2 x
   tp 2 ring, (e) ep 4 with phase 12's 8 experts in f32, drop-free. Each
   against the single-card ``train_step`` on the same batch run here
   first: the loss within PIPE_LOSS_RTOL on every process (the same
   bits everywhere), the update within DP_REL_LIMIT per tensor, every
   replicated slice the same bits on every process holding it, and K2,
   K4 and K5 launched layers x ring steps times a step on every process
   (set to 0 before the step, read after); the median wall a step, peak
   memory a process and bytes staged through the host a step. (f) K4
   and K5 at a ring step's shapes (64 folded heads x 256 x 64 bf16)
   against their plain versions, for a fully visible earlier shard's
   block and a fully masked later one (dk = dv = 0 exactly, dq its plain
   version's, K2's carried state unchanged).
17. The rootless serving fabric over the card's DecodeServers
   (``phase_fabric``): fleets of four full-width ``DecodeServer`` ranks
   (one shared cast set of weights) in the port's deterministic
   simulator, each behind ``ModelBackend`` and a ``DecodeFabric``
   (rootless-broadcast admission, IAR placement, fail-over with an
   exactly-once re-queue): (a) dense (buckets 64 and 256, prompts of
   64-384) and (b) paged (pages of 128, prompts one of four shared
   256-token prefixes and a 32-128-token tail); 32 requests, 8 through
   each gateway, the busiest rank killed at virtual t 3 and its server
   released. Every request completes exactly once on every live rank
   with the same tokens there, at least one is re-queued, every
   completion equals its prompt's own ``generate`` but at a near-tie, K2,
   K6, K7 and K8 launch in (a) and K9, K10 and K11 in (b) (the counts set
   to 0 before each fleet and read after); wall, virtual drain time,
   rounds a rank, tokens/s, re-queues, prefix hits, COW copies, the
   fabric's virtual-time latencies, peak memory, and whether (a) run
   again on the seed repeats its schedule digest and tokens. (a) runs a
   third time with a ``SpanRecorder`` on every rank: its decisions
   (victim, re-queues, rounds, tokens, virtual latencies) must equal
   the unrecorded run's, and its per-rank span dumps go to phase 19.
18. The host facades fed card tensors (``phase_host_facades``,
   ``phase_host_procs``): (a) ``init("native", world_size=8)`` (the
   port's copy of the C core) and (b) ``init("loopback")`` (the port's
   Python engines and ``ops/collectives.py``), each given per-rank
   tensors on the card: the f32 allreduce by the ring, the sum at
   256 MB a rank on native and at 32 MB on loopback, min and max at
   32 MB on both (they re-measure the same copies and protocol), the
   int32 sum at 1 MB (native by bcast-gather),
   reduce_scatter and all_gather at 32 MB, all_to_all, a bcast (1 MB
   native, 16 KB loopback: under each engine's frame cap) from rank 5,
   consensus all YES and with a veto, barrier and a 4-member
   sub-group; (c) ``init("mpi")`` in four processes under the port's
   femtompirun and (d) ``init("tcp")`` under its tcprun
   (``chip_smoke.py --host-worker``), each holding its rank's tensors on
   the card: the ring allreduce at 256 MB a rank, consensus with a veto,
   all_gather and a 2-member sub-group. Every result is held bit for
   bit against ``TorchBackend`` on the same card tensors, op, world and
   schedule and must come back as a tensor on the card; each op prints
   its wall split into staging (card to host, host to card) and the
   host protocol, the ring allreduce its GB/s a rank, and the
   TorchBackend call its time and K1 launches.
19. The developer tools (``phase_tools``): (a) ``python -m
   rlo_tpu_torch.tools.runner --json`` on the tree the script runs from
   (rlo-lint, rlo-sentinel, rlo-prover, rlo-model): 0 findings, each
   tool's seconds; (b) the byte pinning on the card: 8 ranks of a
   ``LocalMesh`` at 256 MB fp32 a rank through ``RecordingAxis`` (ring,
   bidir ring at 1/2/4 sub-chunks, halving-doubling, recursive doubling,
   hierarchical 2 x 4 with int8 over the outer axis, direct
   all-to-all): bytes handed to ``ppermute`` and the number of calls
   equal the cost model and the ledger, results equal an unrecorded
   run's bit for bit, K1's launches counted; (c) K6-K11 at rlo-prover
   P3's probe shapes with hostile positions (negative, past max_len),
   page ids (past the pool, negative) and the null page, each result
   equal to its plain twin's and the dropped rows untouched, in a
   ``chip_smoke.py --hostile-worker`` process under ``compute-sanitizer
   --tool memcheck`` where it can run a CUDA program, bare where it
   cannot (said so); (d) rlo-scope over per-rank tracer dumps of an
   instrumented ring allreduce through the loopback facade (8 ranks,
   32 MB card tensors a rank): no predicted-vs-measured finding, the
   GB/s of each step; rlo-trace over phase 17's span dumps: no
   incomplete trace.
20. The collectives' backward (``phase_grad_parallel``): (a) K1 with a
   backward, ``FusedCombine``, against its plain path (``use_kernel=False``,
   JAX's min/max rule: a winning NaN gives neither operand a share)
   on the same card tensors (f32/bf16 x sum/min/max at 32 MB and a
   ragged size, integer-valued operands with ties and NaNs): the forward
   and both gradients bit-identical, one K1 launch a forward and none in
   the backward, the forward + backward timed against the plain
   path's; then four ``chip_smoke.py --grad-parallel-worker``
   processes over gloo on the one card: (b) every differentiable
   collective at 1 MB f32 a rank (the four manual allreduces with sum
   and max, reduce-scatter ring and halving, all-gather xla, ring and
   doubling, the three bcast schedules from rank 2, hierarchical 2 x 2
   with psum and ring over dcn), integer-valued inputs and cotangents,
   each process's gradient equal to its closed form (the sum of every
   rank's cotangent, the winning rank's mask, ...), K1 launched the
   schedule's combines in a forward and never in a backward; (c) the
   gradient of sum(logits * c) through ``forward`` under tp 4 with each
   manual ``tp_algorithm`` (the flagship config at phase 9's global
   batch, c a fixed random cotangent) within DP_REL_LIMIT relative L2
   per leaf of 4 x the single card's gradient (a manual schedule's
   logits vary over tp), every replicated leaf the same bits on every
   process, K1 launched layers x 2 sums x the schedule's combines in the
   forward and K2/K4/K5 once a layer; each schedule's wall, peak and
   bytes staged through the host a process.
21. Past CUDA's 65,535 blocks on grid.y/z and the model-parallel paths
   as processes: (a) ``phase_grid_limits``: K2 and K3-K5 at 65,536 and
   70,001 folded heads (bf16 and f32, Lq = Lk = 16, D 16) within phases
   5's and 7's tolerances of their plain versions, K8 and K11 at 65,536
   and 70,001 (row, head) blocks bit-equal to indexed assignment, K6 over
   65,536 * 256 + 1 positions (4.3 GB of bf16 cache; the entry widens the
   split to 512) and over 65,536 row tiles within phase 5's tolerance,
   each call one launch a chunk of 65,535 blocks (counted) and timed by
   events; (b) ``phase_proc_parallel``: four ``chip_smoke.py
   --proc-parallel-worker`` processes over gloo on the one card run
   phase 13's TP generate (tp 4, the ring tp schedule, 32 x 1024, 8 new
   tokens) and EP generate (ep 4, bf16, 'xla' all_to_all) and one GPipe
   and one 1F1B step at pp 4 (phase 14's 8 x 1024); tokens, stage updates
   and losses bit-equal to the same runs on a ``LocalMesh`` on the card;
   walls, launches of K1, K2, K4-K7 and bytes staged through the host a
   process.
22. One JSON line of kernel figures, each with the path whose launches
   it counts (and ``launches_by_path`` for phases 11-21), then the last
   line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --time-writes

runs only the K7, K8, K10 and K11 timings of phase 4 and K1's of phase
2 and prints them as one JSON line; they call nothing the port lacked
before the writes took views and pairs, so a copy of this file at the
root of an older tree times that tree's kernels the same way.

    python3 chip_smoke.py --time-decode

likewise times K6 and K9 alone at the serving path's shapes (the
flagship decode shape, 289 pages in turns with K6, GQA batch 4, a
128-token prefill chunk) by device time, events and host time a call
(``time_attend``), calling nothing the port lacked before the split.

    python3 chip_smoke.py --time-k3

likewise times K3 alone at the training shape, causal and not, by
events and device time, with a digest of its counts (``time_k3``).

    python3 chip_smoke.py --time-flash

likewise times K2 at the prefill shape, K4/K5 at the training shape
and at the training cell's (``CELL_BWD``) and K5 at D 16 and 32, with a
digest of each output (``time_flash``).

Every profiled window (``profiled``: device times, the kernels a call
runs) opens with 64 launches of a spin kernel that it leaves out (the
profiler can lose a window's first few launches) and idles a few ms
inside both of its edges; one that records no CUDA kernel at all is
taken again with a longer idle, 3 takes in all before it fails, and
each phase prints how many it took again and how many opener launches
went unrecorded (a K6/K9 window short of its launches is taken again
too, printing where its recorded launches lie in the window). Every
failure raises, so the exit code is non-zero and no result line is
printed.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 20261016
WS = 8
N_FULL = 64 * 2 ** 20          # 256 MB of fp32 per rank (BASELINE size)
PEAK_HBM_BYTES_S = 3.35e12     # H100 SXM data sheet
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core rate
K1_SOURCE = "rlo_tpu_torch/kernels/csrc/reduce.cu"
K1_REPLACES = "rlo_tpu/pallas/reduce.py:49"
#: 16-byte vectors one block of K1 covers in a step of its loop, and its
#: grid's cap in blocks an SM (csrc/reduce.cu: kThreads x kUnroll,
#: grid_for)
K1_BLOCK_VECS = 256 * 4
K1_BLOCKS_PER_SM = 256
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


#: torch.profiler drops kernel records now and then, a few windows in a
#: row at a time (one-launch windows back to back: 2 to 6 in 1000
#: recorded no kernel, and an idle pause before each window did not
#: help; one in 250 fifty-launch windows recorded 49), so each window
#: idles inside its edges, after the profiler starts and before it
#: stops: WINDOW_IDLE_S on its first take, ten times longer on each
#: retake. A window that records no CUDA kernel at all is taken again,
#: WINDOW_TAKES takes in all before it fails (a K6/K9 window short of
#: its launches too: ``_attend_device_ms``).
WINDOW_IDLE_S = 0.005
WINDOW_TAKES = 3
#: In some processes the profiler loses the first few launches of every
#: window, whatever the idle: 1 of 50 K6 launches in each take on some
#: machines, 5 after phase 13 (45 of 50 with 5, 50 and 500 ms idles; a
#: spin kernel launched after the 50 calls was recorded, one launched
#: before them was not, and the 45 recorded launches ran back to back).
#: So every window opens with WINDOW_OPENERS launches of
#: ``torch.cuda._sleep``'s spin kernel (WINDOW_OPENER: nothing else runs
#: it) and a synchronise, before its idle; they are left out of what the
#: window recorded, and how many of them went unrecorded is reported
#: (up to 13 of 32 in a full run's later windows: 64 leaves room).
WINDOW_OPENERS = 64
WINDOW_OPENER = "spin_kernel"
#: profiled windows since the last ``windows_line``, and how many of them
#: recorded no kernel and were taken again
windows = {"taken": 0, "empty": 0}
#: the most opener launches a window since the last ``windows_line`` did
#: not record
openers = {"lost": 0}


def _device_us(evt) -> float:
    return float(getattr(evt, "device_time_total", 0)
                 or getattr(evt, "cuda_time_total", 0))


#: where the kernels of the last profiled window lie in it (``_spread``)
last_window = {}


def profiled(fn, reps: int = 1) -> dict:
    """The CUDA kernels (and copies) of ``reps`` calls of ``fn`` by name,
    as {name: (count, device us)} from ``torch.profiler``: one window that
    starts after a synchronise, launches its openers (``WINDOW_OPENERS``)
    and synchronises, idles, runs the calls, synchronises and idles again
    before it stops; taken again as ``WINDOW_IDLE_S`` says."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for take in range(WINDOW_TAKES):
        idle = WINDOW_IDLE_S * 10 ** take
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(WINDOW_OPENERS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            time.sleep(idle)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(idle)
        windows["taken"] += 1
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        lost = WINDOW_OPENERS - sum(e.count for e in kernels
                                    if WINDOW_OPENER in e.key)
        openers["lost"] = max(openers["lost"], lost)
        last_window.update(idle_us=idle * 1e6, prof=prof, openers_lost=lost,
                           host_us=(time.perf_counter() - t0) * 1e6)
        ran = {e.key: (e.count, _device_us(e)) for e in kernels
               if WINDOW_OPENER not in e.key}
        if ran:
            return ran
        windows["empty"] += 1
    raise RuntimeError(f"chip_smoke: FAILED: the profiler recorded no CUDA "
                       f"kernel in {WINDOW_TAKES} windows in a row")


def windows_line(tag: str) -> None:
    """Print and reset the profiled-window counts of a phase."""
    print(f"[{tag}] profiler windows: {windows['taken']}, of which "
          f"{windows['empty']} recorded no kernel and were taken again; "
          f"at most {openers['lost']} of a window's {WINDOW_OPENERS} opener "
          f"launches went unrecorded")
    windows.update(taken=0, empty=0)
    openers.update(lost=0)


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one ``fn()`` call: its kernels' times summed by
    ``torch.profiler`` over ``reps`` calls, divided by ``reps``. Leaves
    out the host time between the kernels of a call (autograd's engine
    around SDPA's backward), which CUDA events around a run include."""
    fn()
    us = sum(t for _, t in profiled(fn, reps).values())
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
    cap = torch.cuda.get_device_properties(dev).multi_processor_count \
        * K1_BLOCKS_PER_SM

    def edges(esize):
        """Sizes around one block's step of the unrolled loop, with a
        scalar tail or none, and one past the grid's cap (a second pass of
        the grid-stride loop, 553 MB an operand)."""
        per = 16 // esize
        step = K1_BLOCK_VECS * per
        return [per - 1, per + 1, step - 1, step, step + per + 3,
                3 * step - per, cap * step + per]

    tally = {"cases": 0, "worst": 0.0}

    def compare(got, want, what):
        torch.cuda.synchronize()
        check(same_bits(got, want), f"K1 {what} is not bit-identical to "
                                    f"its plain version")
        tally["cases"] += 1
        tally["worst"] = max(tally["worst"], abs_err(got, want))

    for dtype, op in cases:
        for n in sizes + edges(torch.empty((), dtype=dtype).element_size()):
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
        for n in [1000] + edges(1)[4:6]:
            a = torch.randint(0, 2, (n,), generator=gen, device=dev) \
                .to(dtype)
            b = torch.randint(0, 2, (n,), generator=gen, device=dev) \
                .to(dtype)
            for op in ("and", "or"):
                compare(k1.fused_combine(a, b, op),
                        k1.fused_combine_plain(a, b, op),
                        f"{op} on {dtype} n={n}")
    print(f"[k1] {tally['cases']} cases bit-identical to "
          f"fused_combine_plain on the card (NaN payloads included; ragged "
          f"tails, the unrolled loop's block edges and a second pass of its "
          f"grid, unaligned views, out = a); max |err| {tally['worst']}")

    out = time_k1(dev, gen, n_full)
    out["max_abs_err"] = tally["worst"]
    return out


def time_k1(dev, gen, n_full: int) -> dict:
    """K1's f32 sum at the main path's sizes, the whole 256 MB buffer and
    a ring chunk (n/8, 32 MB), beside ``torch.add(out=)``: by CUDA events
    around one call, by device time (the profiler) and by host time; the
    plain version by events. Calls only what the parent tree has too
    (``--time-writes``)."""
    import torch
    from rlo_tpu_torch.kernels import reduce as k1
    out = {}
    for label, n in (("256MB", n_full), ("ring_chunk", n_full // WS)):
        a, b = k1_operands(n, torch.float32, gen, dev, nan=False)
        c = torch.empty_like(a)

        def kern():
            k1.fused_combine(a, b, "sum", out=c)

        def lib():
            torch.add(a, b, out=c)

        # one add per 12 bytes moved: bound by HBM bytes at every size
        nbytes = 3 * n * 4
        st = out[label] = dict(
            ms=time_ms(kern), library_ms=time_ms(lib),
            plain_ms=time_ms(lambda: k1.fused_combine_plain(a, b, "sum",
                                                            out=c)),
            device_ms=device_ms(kern, 20),
            library_device_ms=device_ms(lib, 20),
            host_us=host_us(kern, 200), library_host_us=host_us(lib, 200),
            bound_ms=nbytes / PEAK_HBM_BYTES_S * 1e3, bound_by="bytes")
        print(f"[k1] f32 sum n={n} ({n * 4 / 2 ** 20:.0f} MiB each): kernel "
              f"{st['ms']:.4f} ms by events, {st['device_ms']:.5f} ms device "
              f"({100 * st['bound_ms'] / st['device_ms']:.1f}% of bound), "
              f"{st['host_us']:.2f} us host; torch.add {st['library_ms']:.4f}"
              f" / {st['library_device_ms']:.5f} ms / "
              f"{st['library_host_us']:.2f} us; plain {st['plain_ms']:.4f} "
              f"ms; bound {st['bound_ms']:.4f} ms (3 x n x 4 B at 3.35 TB/s)")
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


def _q_view(q):
    """q (b, T, nh, hd) as the decode step passes it to K6/K9: the middle
    third of a (b, T, 3 * nh * hd) projection, read in place."""
    import torch
    b, T, nh, hd = q.shape
    proj = torch.zeros(b, T, 3 * nh * hd, dtype=q.dtype, device=q.device)
    proj[..., nh * hd:2 * nh * hd] = q.reshape(b, T, nh * hd)
    return proj[..., nh * hd:2 * nh * hd].reshape(b, T, nh, hd)


def _split_edges(b, T, L, gen, dev):
    """(b,) int32 positions for a T-query call: rows whose T positions
    cross a split edge (at 1, 2 and 3 splits), one past max_len (a
    retired slot), the rest spread over [0, L - T]."""
    import torch
    from rlo_tpu_torch.kernels import decode as kd
    pos = torch.randint(0, L - T + 1, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    S = kd.SPLIT_K
    edges = [S - 2, 2 * S - 1, 3 * S - T + 1, L + 1, 0][:b]
    pos[:len(edges)] = torch.tensor(edges, dtype=torch.int32, device=dev)
    return pos


def _attend_bits(call, q, pos, what) -> None:
    """K6/K9's bit gates: row t of a T-query call at pos p equals a T = 1
    call at p + t (q[:, t:t + 1], a strided view); 50 repeat launches give
    the first launch's bits (the in-launch merge runs in split order); q
    read in place from the projection's view gives its contiguous copy's
    bits. ``call(q, pos)`` launches the kernel."""
    import torch
    block = call(q, pos)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(block).all()), f"{what}: non-finite output")
    for t in range(q.shape[1]):
        one = call(q[:, t:t + 1], pos + t)
        torch.cuda.synchronize()
        check(same_bits(one[:, 0], block[:, t]),
              f"{what}: row {t} of T = {q.shape[1]} at pos differs from T = 1"
              f" at pos + {t}: max |err| {abs_err(one[:, 0], block[:, t])}")
    for _ in range(50):
        again = call(q, pos)
        torch.cuda.synchronize()
        check(same_bits(again, block), f"{what}: a repeat launch gave other "
                                       f"bits")
    got = call(_q_view(q), pos)
    torch.cuda.synchronize()
    check(same_bits(got, block), f"{what}: q read from the projection's "
                                 f"view differs from its contiguous copy")


def _spread(keep) -> str:
    """Where the last profiled window's kernels whose name passes
    ``keep`` lie: the first one's start and the last one's end in us
    from the window's start, the window's host length and idle edges,
    and the gaps between launches."""
    import torch
    events = getattr(last_window.get("prof"), "events", None)
    ev = sorted((e for e in (events() if callable(events) else ())
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and keep(e.key)), key=lambda e: e.time_range.start)
    if not ev:
        return "no event times"
    starts = [e.time_range.start for e in ev]
    gaps = [y - x for x, y in zip(starts, starts[1:])] or [0.0]
    i = max(range(len(gaps)), key=gaps.__getitem__)
    return (f"{last_window['openers_lost']} of {WINDOW_OPENERS} openers "
            f"unrecorded; recorded launches from {starts[0]:.0f} to "
            f"{ev[-1].time_range.end:.0f} us into a "
            f"{last_window['host_us']:.0f} us window with "
            f"{last_window['idle_us']:.0f} us idle edges; gaps between "
            f"launches median {statistics.median(gaps):.1f} us, largest "
            f"{gaps[i]:.1f} us after launch {i}")


def _attend_device_ms(fn, counted, paged, what, reps: int = 50) -> float:
    """Device ms of one K6 (``paged`` False) or K9 call, from one profiled
    window of ``reps`` calls that is also the one-launch gate: the calls
    add exactly ``reps`` to ``counted``'s count (on the host) and the card
    ran ``reps`` launches of that kernel and nothing else (the profiler):
    no copy of q, no second pass. A window that shows fewer launches of
    the kernel and nothing else lost records (see ``WINDOW_OPENERS``): it
    prints where its recorded launches lie and is taken again,
    ``WINDOW_TAKES`` takes in all before it fails."""
    fn()
    for _ in range(WINDOW_TAKES):
        before, taken = counted.launches, windows["taken"]
        ran = profiled(fn, reps)
        calls = reps * (windows["taken"] - taken)  # every take runs its calls
        check(counted.launches == before + calls,
              f"{what}: {calls} calls took {counted.launches - before} "
              f"launches")
        mine = {k: v for k, v in ran.items() if "decode_kernel" in k
                and ("paged_decode_kernel" in k) == paged}
        seen = sum(c for c, _ in mine.values())
        check(len(mine) == len(ran) and seen <= reps,
              f"{what}: the card ran {ran} in {reps} calls, not {reps} "
              f"launches of its kernel")
        if seen == reps:
            us = sum(t for _, t in mine.values())
            check(us > 0, f"{what}: the profiler recorded no device time")
            return us / reps / 1e3
        print(f"[{what}] the profiler recorded {seen} of {reps} launches "
              f"({_spread(mine.__contains__)}); window taken again")
    raise RuntimeError(f"chip_smoke: FAILED: {what}: the card ran {ran} in "
                       f"{reps} calls, not {reps} launches of its kernel, in "
                       f"{WINDOW_TAKES} windows")


def phase_k6(dev) -> dict:
    """K6 at T = 1 and 4, batch 32, L 1088 (five splits of SPLIT_K), 16 kv
    heads, hd 64, bf16 and int8 caches, scalar and ragged positions (one
    past max_len, as a retired serving slot has), plus GQA groups 2 and 8
    (GQA batch 4 also at T = 128), against the plain twin at SPLIT_K.
    Tolerance rtol 1e-3 / atol 2e-3: the kernel and its plain twin share
    the tile and split partition and the bf16 roundings, and differ in f32
    summation order and the last bit of exp (which can move a probability
    across a bf16 rounding boundary). Then the bit gates (``_attend_bits``)
    at T = 4 over rows crossing split edges, bf16 and int8, and one launch
    a call. Times K6 (events and device time by the profiler) beside
    ``scaled_dot_product_attention`` (its device time too: by events a
    call this short includes the host's time)."""
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
            for T in (1, 4) + ((128,) if nkv == 2 else ()):
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
          f"64, GQA groups 1/2/8, GQA batch 4 also at T 128, bf16/int8/f32 "
          f"caches, scalar and ragged pos incl. one past max_len; "
          f"{-(-L // kd.SPLIT_K)} splits of {kd.SPLIT_K}) within rtol 1e-3 "
          f"/ atol 2e-3 of the plain version at SPLIT_K; max |err| "
          f"{worst:.3g}")
    for kind in ("bf16", "int8"):
        for b, nkv, nh in ((32, 16, 16), (4, 2, 16)):
            k, v, ks, vs = caches(b, nkv, kind)
            q = torch.randn(b, 4, nh, 64, generator=gen,
                            device=dev).to(torch.bfloat16)
            _attend_bits(lambda q_, p_: kd.flash_block_decode(
                q_, k, v, p_, 0.125, ks, vs), q,
                _split_edges(b, 4, L, gen, dev), f"K6 {kind} b={b} kvh={nkv}")
    print("[k6] bit gates: row t of T = 4 equals T = 1 at pos + t, 50 repeat "
          "launches equal, q from the projection's view equals its copy "
          "(bf16 and int8, batch 32 x 16 and GQA batch 4 x 2, rows across "
          "split edges)")

    out = {}
    for kind in ("bf16", "int8"):
        k, v, ks, vs = caches(32, 16, kind)
        q = torch.randn(32, 1, 16, 64, generator=gen,
                        device=dev).to(torch.bfloat16)
        pos = torch.tensor(L - 1, dtype=torch.int32, device=dev)
        f = lambda: kd.flash_block_decode(q, k, v, pos, 0.125,  # noqa: E731
                                          ks, vs)
        kern = time_ms(f)
        kern_dev = _attend_device_ms(f, kd.flash_block_decode, False,
                                     f"K6 {kind}")
        plain = time_ms(lambda: kd.flash_block_decode_plain(
            q, k, v, pos, 0.125, ks, vs), iters=5)
        lib = lib_dev = None
        if kind == "bf16":
            qh = q.transpose(1, 2)                        # (b, h, 1, d)
            kh, vh = k.transpose(2, 3), v.transpose(2, 3)  # (b, h, L, d)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qh, kh, vh, scale=0.125)
            lib, lib_dev = time_ms(sdpa), device_ms(sdpa, 50)
        nbytes = 2 * k.numel() * k.element_size() + (
            2 * ks.numel() * 4 if ks is not None else 0)
        bound = nbytes / PEAK_HBM_BYTES_S * 1e3
        out[kind] = dict(ms=kern, device_ms=kern_dev, plain_ms=plain,
                         library_ms=lib, library_device_ms=lib_dev,
                         bound_ms=bound, bound_by="bytes")
        print(f"[k6] T=1 batch 32 x 16 kv heads x L {L} {kind} cache: kernel "
              f"{kern:.4f} ms by events, {kern_dev:.5f} ms device, plain "
              f"{plain:.4f} ms, scaled_dot_product_attention "
              f"{'n/a' if lib is None else f'{lib:.4f} / {lib_dev:.5f} ms'}"
              f", bound {bound:.4f} ms ({nbytes} B of live cache / 3.35 "
              f"TB/s), kernel at {100 * bound / kern_dev:.1f}% of bound by "
              f"device time ({100 * bound / kern:.1f}% by events)")
    out["bf16"]["max_abs_err"] = worst
    return out


def _attend_times(fn, nbytes, lib=None) -> dict:
    """K6/K9's figures for one call: device time of the decode kernel
    alone and of every kernel the call runs (a copy of q included) over
    50 calls (``profiled``), launches a call, CUDA events around one
    call, host time a call over 200 calls, and the byte bound (the live
    bytes over 3.35 TB/s); with ``lib`` the same for its yardstick."""
    fn()
    ran = profiled(fn, 50)
    mine = sum(us for k, (_, us) in ran.items() if "decode_kernel" in k)
    check(mine > 0, "the profiler recorded no decode kernel")
    bound = nbytes / PEAK_HBM_BYTES_S * 1e3
    out = dict(device_ms=mine / 50 / 1e3,
               call_device_ms=sum(us for _, us in ran.values()) / 50 / 1e3,
               launches=sum(c for c, _ in ran.values()) / 50,
               ms=time_ms(fn, iters=100, warmup=10),
               host_us=host_us(fn, n=200), bound_ms=bound)
    out["pct_of_bound"] = 100 * bound / out["device_ms"]
    if lib is not None:
        out.update(library_device_ms=device_ms(lib, 50),
                   library_ms=time_ms(lib, iters=100, warmup=10))
    return out


def time_attend(dev, gen) -> dict:
    """K6 and K9 alone at the serving path's shapes, head_dim 64, bf16
    queries (``_attend_times``): K6 at the flagship decode shape (batch
    32 x 16 kv heads x 1088 positions, T 1, one shared position at the
    end; bf16 and int8 caches), bf16 beside ``scaled_dot_product_attention``;
    K9 over 289 permuted pages of 128 holding those columns, ragged
    positions, in turns with K6 on the same columns (K9, K6, K6, K9); K6
    at GQA batch 4 (4 rows x 2 kv heads, 16 query heads); K9 on one
    128-token prefill chunk (batch 1 x 16 heads at position 896, 9 pages
    of the 289). Calls only what the parent tree has too
    (``--time-decode``)."""
    import torch
    import torch.nn.functional as F
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.models.paged import pages_from_dense
    L, ps = 1088, 128
    mp = -(-L // ps)
    P = 32 * mp + 1
    table = (torch.randperm(P - 1, generator=gen, device=dev) + 1) \
        .to(torch.int32).reshape(32, mp).contiguous()

    def caches(b, nkv, kind):
        k = torch.randn(b, nkv, 64, L, generator=gen, device=dev)
        v = torch.randn(b, nkv, 64, L, generator=gen, device=dev)
        if kind == "bf16":
            return {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
        (k, ks), (v, vs) = _int8_cache(k), _int8_cache(v)
        return {"k": k, "v": v, "ks": ks, "vs": vs}

    def live_bytes(pos, T, c):
        """k, v (and the scales) of positions [0, pos_b + T) of each row,
        each read once."""
        b, nkv = c["k"].shape[:2]
        live = int((pos.long().expand(b) + T).clamp(0, L).sum())
        return live * nkv * (2 * 64 * c["k"].element_size()
                             + (8 if "ks" in c else 0))

    def q_of(b, T):
        return torch.randn(b, T, 16, 64, generator=gen,
                           device=dev).to(torch.bfloat16)

    out = {}
    for kind in ("bf16", "int8"):
        c = caches(32, 16, kind)
        q = q_of(32, 1)
        pos = torch.tensor(L - 1, dtype=torch.int32, device=dev)
        lib = None
        if kind == "bf16":
            qh = q.transpose(1, 2)
            kh, vh = c["k"].transpose(2, 3), c["v"].transpose(2, 3)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qh, kh, vh, scale=0.125)
        out[f"K6 {kind} T=1 flagship"] = _attend_times(
            lambda: kd.flash_block_decode(q, c["k"], c["v"], pos, 0.125,
                                          c.get("ks"), c.get("vs")),
            live_bytes(pos, 1, c), lib)
        ragged = torch.randint(0, L, (32,), generator=gen, device=dev,
                               dtype=torch.int32)
        pg = pages_from_dense([c], table, P, ps)[0]
        nbytes = live_bytes(ragged, 1, c) + table.numel() * 4
        f9 = lambda: kd.paged_flash_decode(  # noqa: E731
            q, pg["k"], pg["v"], table, ragged, 0.125, pg.get("ks"),
            pg.get("vs"))
        f6 = lambda: kd.flash_block_decode(  # noqa: E731
            q, c["k"], c["v"], ragged, 0.125, c.get("ks"), c.get("vs"))
        t = [_attend_times(f, nbytes) for f in (f9, f6, f6, f9)]
        out[f"K9 {kind} T=1 289 pages"] = [t[0], t[3]]
        out[f"K6 {kind} T=1 same columns"] = [t[1], t[2]]
        del c, pg
    c = caches(4, 2, "bf16")
    q = q_of(4, 1)
    pos = torch.tensor(L - 1, dtype=torch.int32, device=dev)
    out["K6 bf16 T=1 GQA batch 4"] = _attend_times(
        lambda: kd.flash_block_decode(q, c["k"], c["v"], pos, 0.125),
        live_bytes(pos, 1, c))
    c = caches(1, 16, "bf16")
    pg = pages_from_dense([c], table[:1], P, ps)[0]
    q = q_of(1, 128)
    pos = torch.tensor(896, dtype=torch.int32, device=dev)
    out["K9 bf16 T=128 prefill chunk at 896"] = _attend_times(
        lambda: kd.paged_flash_decode(q, pg["k"], pg["v"], table[:1], pos,
                                      0.125),
        live_bytes(pos, 128, c) + mp * 4)
    return out


def _vector_loads(rows) -> bool:
    """Whether ``rows`` (.., hd, T) meet the block-write kernel's test for
    16-byte loads along hd: hd contiguous, a multiple of 16 bytes, and
    every token's start 16-byte aligned (else it loads scalars)."""
    e = rows.element_size()
    return (rows.stride(-2) == 1 and rows.shape[-2] * e % 16 == 0
            and rows.stride(-1) * e % 16 == 0 and rows.data_ptr() % 16 == 0)


def _proj_views(lead, T, nkv, hd, dtype, gen, dev, misaligned=False):
    """(k, v) rows (lead.., kvh, hd, T) as the model hands them to K8/K11:
    permuted views of the k and v slices of one (lead.., T, 3 * kvh * hd)
    projection output (hd contiguous, tokens 16-byte aligned, so the
    kernel loads 16 bytes along hd); ``misaligned`` moves both slices one
    element on in a (lead.., T, 3 * kvh * hd + 1) tensor (scalar loads)."""
    import torch
    w, pad = nkv * hd, int(misaligned)
    shape = tuple(lead) + (T, 3 * w + pad)
    if dtype == torch.int8:
        proj = torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    else:
        proj = torch.randn(shape, generator=gen, device=dev).to(dtype)
    n = len(lead)
    perm = tuple(range(n)) + (n + 1, n + 2, n)
    kv = tuple(proj[..., a + pad:a + pad + w]
               .reshape(tuple(lead) + (T, nkv, hd)).permute(perm)
               for a in (w, 2 * w))
    vec = hd * proj.element_size() % 16 == 0 and not misaligned
    check(all(_vector_loads(x) == vec for x in kv),
          f"the {'misaligned ' if misaligned else ''}views do not take the "
          f"route they are meant to")
    return kv


def _row_views(b, nkv, hd, dtype, gen, dev, misaligned=False):
    """(k, v) rows (b, kvh, hd) as the paged decode step hands them to
    K10: ``k[:, 0]`` and ``v[:, 0]`` of one (b, 1, 3 * kvh * hd)
    projection output (``_proj_views`` at T = 1)."""
    return tuple(x[..., 0] for x in _proj_views((b,), 1, nkv, hd, dtype,
                                                gen, dev, misaligned))


def _same_repeats(fn, dsts, srcs, args, what, n=50) -> None:
    """``n`` launches of a pair write give the first launch's bits."""
    import torch
    first = None
    for _ in range(n):
        a = [x.clone() for x in dsts]
        fn(a[0], srcs[0], *args, a[1], srcs[1])
        torch.cuda.synchronize()
        first = first or a
        check(same_bits(a[0], first[0]) and same_bits(a[1], first[1]),
              f"{what}: a repeat launch gave other bits")


def _one_prep_a_k5(launches: dict, where: str) -> None:
    """A bf16 K5 call under 65,536 heads is one launch of K5 after one of
    its prepass (``bwd_dkv_prep``): on a path that runs no f32 backward
    the two counts are equal."""
    check(launches["bwd_dkv_prep"] == launches["bwd_dkv"],
          f"K5's prepass launched {launches['bwd_dkv_prep']} times on "
          f"{where}, K5 {launches['bwd_dkv']} times")


def _same_pair(fn_k, fn_p, dsts, srcs, args, what) -> None:
    """A write's pair form: one launch, both destinations bit-identical
    to the plain version's."""
    import torch
    a, b = [x.clone() for x in dsts], [x.clone() for x in dsts]
    before = fn_k.launches
    fn_k(a[0], srcs[0], *args, a[1], srcs[1])
    check(fn_k.launches == before + 1,
          f"{what} took {fn_k.launches - before} launches")
    fn_p(b[0], srcs[0], *args, b[1], srcs[1])
    torch.cuda.synchronize()
    check(same_bits(a[0], b[0]) and same_bits(a[1], b[1]),
          f"{what} is not bit-identical to its plain version")


def launched_kernels(fn) -> dict:
    """The CUDA kernels (and copies) one ``fn()`` call runs on the card,
    by name, with their counts (the profiler)."""
    fn()
    return {k: c for k, (c, _) in profiled(fn).items()}


def host_us(fn, n: int = 1000, rounds: int = 3) -> float:
    """Host time of one ``fn()`` call, in microseconds: ``perf_counter``
    around ``n`` calls in a row with no synchronise inside (at the writes'
    sizes the card outruns the host, so this is the wrapper's Python and
    launch time), the median of ``rounds`` such runs."""
    import torch
    for _ in range(20):
        fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _write_times(kernel, lib, path=None, path_lib=None) -> dict:
    """A write's times by CUDA events around one call, by device time
    (the profiler) and by host time, beside its yardstick's; with
    ``path`` also the caller's k/v pair write against two sliced
    assignments."""
    out = dict(ms=time_ms(kernel), library_ms=time_ms(lib),
               device_ms=device_ms(kernel, 50),
               library_device_ms=device_ms(lib, 50),
               host_us=host_us(kernel), library_host_us=host_us(lib),
               library_ran=sorted(launched_kernels(lib)))
    if path is not None:
        out.update(path_ms=time_ms(path), path_library_ms=time_ms(path_lib),
                   path_device_ms=device_ms(path, 50),
                   path_library_device_ms=device_ms(path_lib, 50),
                   path_host_us=host_us(path),
                   path_library_host_us=host_us(path_lib))
    return out


def _one_launch(path, counted, kernel, what) -> None:
    """The caller's pair write costs one launch of ``counted`` (its own
    count, on the host: exact) and runs no other kernel and no copy of
    its source on the card: the profiler sees ``kernel`` and nothing
    else."""
    before = counted.launches
    path()
    launched = counted.launches - before
    check(launched == 1, f"{what}'s pair write took {launched} launches")
    ran = launched_kernels(path)
    check(all(kernel in k for k in ran),
          f"{what}'s pair write ran {ran}, not {kernel} alone")


def _print_write_times(name, shape, st, bound_what) -> None:
    print(f"[{name.lower()}] bf16 {shape}: kernel {st['ms']:.4f} ms by "
          f"events, {st['device_ms']:.5f} ms device, {st['host_us']:.2f} us "
          f"host; indexed assignment {st['library_ms']:.4f} / "
          f"{st['library_device_ms']:.5f} ms / {st['library_host_us']:.2f} "
          f"us; plain {st['plain_ms']:.4f} ms; bound {st['bound_ms']:.6f} ms "
          f"({bound_what} / 3.35 TB/s); the assignment ran "
          f"{[k[:60] for k in st['library_ran']]}")
    if "path_ms" in st:
        print(f"[{name.lower()}] the k/v pair through the caller (one "
              f"launch): {st['path_ms']:.4f} ms by events, "
              f"{st['path_device_ms']:.5f} ms device, {st['path_host_us']:.2f}"
              f" us host; two assignments from the same views "
              f"{st['path_library_ms']:.4f} / "
              f"{st['path_library_device_ms']:.5f} ms / "
              f"{st['path_library_host_us']:.2f} us")
    for k in ("contiguous_device_ms", "contiguous_library_device_ms",
              "misaligned_device_ms", "empty_device_ms",
              "one_column_library_device_ms"):
        if k in st:
            print(f"[{name.lower()}] {k} {st[k]:.5f}")


def time_k7(dev, gen) -> dict:
    """K7 at the dense decode step's shape, bf16: rows (32, 16, 64) into
    column pos_b of a (32, 16, 64, 1088) cache, per-row positions. The
    single form from the decode step's ``k[:, 0]`` view of the projection
    and the k/v pair through ``generate._write_rows``, each beside indexed
    assignment from the same views. Calls only what the parent tree has
    too (``--time-writes``)."""
    import torch
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.models import generate as G
    b, L = 32, 1088
    lc = {x: torch.randn(b, 16, 64, L, generator=gen,
                         device=dev).to(torch.bfloat16) for x in "kv"}
    kv = _row_views(b, 16, 64, torch.bfloat16, gen, dev)
    pos = torch.randint(0, L, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    bidx, pidx = torch.arange(b, device=dev), pos.long()
    cache = lc["k"]

    def lib_view():
        cache[bidx, :, :, pidx] = kv[0]

    def lib_pair():
        lc["k"][bidx, :, :, pidx] = kv[0]
        lc["v"][bidx, :, :, pidx] = kv[1]

    st = _write_times(lambda: kd.write_kv_row(cache, kv[0], pos), lib_view,
                      lambda: G._write_rows(lc, kv[0], kv[1], pos), lib_pair)
    st.update(
        plain_ms=time_ms(lambda: kd.write_kv_row_plain(cache, kv[0], pos)),
        bound_ms=(2 * kv[0].numel() * 2 + b * 4) / PEAK_HBM_BYTES_S * 1e3,
        bound_by="bytes")
    return st


def time_k8(dev, gen) -> dict:
    """K8 at the dense server's block-decode shape, bf16: a (1, 16, 64,
    64) block into columns 64.. of a (1, 16, 64, 256) cache. The single
    form from ``block_decode``'s k view of the projection (the path's
    layout) and the k/v pair through ``generate._write_block``, each
    beside indexed assignment from the same views; the single form from
    contiguous rows beside theirs (device time); to place the single
    form's device time, a launch at pos0 = L (stores nothing) beside an
    assignment of one column. Calls only what the parent tree has too
    (``--time-writes``)."""
    import torch
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.models import generate as G
    lc = {x: torch.randn(1, 16, 64, 256, generator=gen,
                         device=dev).to(torch.bfloat16) for x in "kv"}
    p0, end = (torch.tensor(x, dtype=torch.int32, device=dev)
               for x in (64, 256))
    # block_decode's k and v: (1, kvh, hd, T) views of one projection
    # output, handed to _write_block as (1, kvh, T, hd)
    cols = _proj_views((1,), 64, 16, 64, torch.bfloat16, gen, dev)
    kv = [x.transpose(2, 3) for x in cols]
    rows = cols[0].contiguous()
    cache = lc["k"]

    def lib_pair():
        lc["k"][:, :, :, 64:128] = cols[0]
        lc["v"][:, :, :, 64:128] = cols[1]

    def lib_view():
        cache[:, :, :, 64:128] = cols[0]

    def lib_rows():
        cache[:, :, :, 64:128] = rows

    st = _write_times(lambda: kd.write_kv_block(cache, cols[0], p0),
                      lib_view, lambda: G._write_block(lc, kv[0], kv[1], p0),
                      lib_pair)
    def lib_one():
        cache[:, :, :, 64:65] = cols[0][..., :1]

    st.update(
        contiguous_device_ms=device_ms(
            lambda: kd.write_kv_block(cache, rows, p0), 50),
        contiguous_library_device_ms=device_ms(lib_rows, 50),
        empty_device_ms=device_ms(lambda: kd.write_kv_block(cache, cols[0],
                                                            end), 50),
        one_column_library_device_ms=device_ms(lib_one, 50),
        plain_ms=time_ms(lambda: kd.write_kv_block_plain(cache, cols[0], p0)),
        bound_ms=(2 * rows.numel() * 2 + 4) / PEAK_HBM_BYTES_S * 1e3,
        bound_by="bytes")
    return st


def time_k11(dev, gen) -> dict:
    """K11 at the paged server's prefill-chunk shape, bf16: a (16, 64,
    128) chunk into page 17 of a pool of 289 pages of (16, 64, 128). The
    single form from ``paged_prefill_chunk``'s k view of the projection
    (the path's layout) and the k/v pair through ``paged_write_chunk``,
    each beside indexed assignment from the same views; then, to place
    the single form's device time, from contiguous rows beside their
    assignment (one whole-page copy), from a misaligned view (scalar
    loads), and with n_valid 0 (a launch that stores nothing) beside an
    assignment of one column. Calls only what the parent tree has too
    (``--time-writes``)."""
    import torch
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.models import paged as PG
    P, ps = 289, 128
    entry = {x: torch.randn(P, 16, 64, ps, generator=gen,
                            device=dev).to(torch.bfloat16) for x in "kv"}
    pg, o0, nv, none = (torch.tensor([x], dtype=torch.int32, device=dev)
                        for x in (17, 0, ps, 0))
    kv = _proj_views((), ps, 16, 64, torch.bfloat16, gen, dev)
    odd = _proj_views((), ps, 16, 64, torch.bfloat16, gen, dev, True)
    rows = kv[0].contiguous()
    pool = entry["k"]

    def lib_pair():
        entry["k"][17, :, :, 0:ps] = kv[0]
        entry["v"][17, :, :, 0:ps] = kv[1]

    def lib_view():
        pool[17, :, :, 0:ps] = kv[0]

    def lib_rows():
        pool[17, :, :, 0:ps] = rows

    st = _write_times(
        lambda: kd.write_kv_page_block(pool, kv[0], pg, o0, nv), lib_view,
        lambda: PG.paged_write_chunk(entry, kv[0], kv[1], None, None, pg, o0,
                                     nv), lib_pair)
    def lib_one():
        pool[17, :, :, 0:1] = kv[0][..., :1]

    st.update(
        one_column_library_device_ms=device_ms(lib_one, 50),
        contiguous_device_ms=device_ms(
            lambda: kd.write_kv_page_block(pool, rows, pg, o0, nv), 50),
        contiguous_library_device_ms=device_ms(lib_rows, 50),
        misaligned_device_ms=device_ms(
            lambda: kd.write_kv_page_block(pool, odd[0], pg, o0, nv), 50),
        empty_device_ms=device_ms(
            lambda: kd.write_kv_page_block(pool, kv[0], pg, o0, none), 50),
        plain_ms=time_ms(lambda: kd.write_kv_page_block_plain(
            pool, kv[0], pg, o0, nv)),
        bound_ms=(2 * rows.numel() * 2 + 12) / PEAK_HBM_BYTES_S * 1e3,
        bound_by="bytes")
    return st


def time_k10(dev, gen) -> dict:
    """K10 at the paged decode step's shape, bf16: rows (32, 16, 64) into
    32 distinct pages of a pool of 289 pages of (16, 64, 128). The single
    form from the decode step's ``k[:, 0]`` view of the projection and the
    k/v pair through ``paged_write_rows``, each beside indexed assignment
    from the same views. Calls only what the parent tree has too
    (``--time-writes``)."""
    import torch
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.models import paged as PG
    P, b, ps = 289, 32, 128
    entry = {x: torch.randn(P, 16, 64, ps, generator=gen,
                            device=dev).to(torch.bfloat16) for x in "kv"}
    kv = _row_views(b, 16, 64, torch.bfloat16, gen, dev)
    page = (torch.randperm(P - 1, generator=gen, device=dev)[:b] + 1) \
        .to(torch.int32)
    off = torch.randint(0, ps, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    pidx, oidx = page.long(), off.long()
    pool = entry["k"]

    def lib_view():
        pool[pidx, :, :, oidx] = kv[0]

    def lib_pair():
        entry["k"][pidx, :, :, oidx] = kv[0]
        entry["v"][pidx, :, :, oidx] = kv[1]

    st = _write_times(
        lambda: kd.write_kv_page_row(pool, kv[0], page, off), lib_view,
        lambda: PG.paged_write_rows(entry, kv[0], kv[1], None, None, page,
                                    off), lib_pair)
    st.update(
        plain_ms=time_ms(lambda: kd.write_kv_page_row_plain(pool, kv[0],
                                                            page, off)),
        bound_ms=(2 * kv[0].numel() * 2 + 2 * b * 4) / PEAK_HBM_BYTES_S
        * 1e3, bound_by="bytes")
    return st


def phase_writes(dev) -> dict:
    """K7 and K8 bit-identical to their plain versions, out-of-range
    positions included (they must leave the cache unchanged); K8 from the
    projection's views and K7 from the decode step's, each also in the
    pair form (one launch, 50 repeats the same bits); the decode step's
    k/v write one K7 launch and no copy; then their times at the serving
    path's shapes, by events, by device time and by host time, beside
    indexed assignment's."""
    import torch
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.models import generate as G

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
    # K8 from the path's views (16-byte loads along hd, and one element
    # off: scalar loads), single and pair form; int8 with the scale
    # sidecars' pair through (b, kvh, 1, L); hd 16-128 from the views
    b, L, T = 32, 1088, 64
    ragged = torch.randint(-T, L, (b,), generator=gen, device=dev,
                           dtype=torch.int32)
    ragged[:3] = torch.tensor([L - 5, L + 3, -9], device=dev)
    for dtype in (torch.bfloat16, torch.int8, torch.float32):
        for hd in (16, 32, 64, 128):
            if dtype == torch.int8:
                caches = [torch.randint(-127, 128, (b, 16, hd, L),
                                        generator=gen, device=dev,
                                        dtype=torch.int8) for _ in range(2)]
            else:
                caches = [torch.randn(b, 16, hd, L, generator=gen,
                                      device=dev).to(dtype) for _ in range(2)]
            scales = [torch.rand(b, 16, 1, L, generator=gen, device=dev)
                      for _ in range(2)]
            srows = _proj_views((b,), T, 16, 1, torch.float32, gen, dev)
            for odd in ((False, True) if hd == 64 else (False,)):
                kv = _proj_views((b,), T, 16, hd, dtype, gen, dev, odd)
                for pos in ((ragged, torch.tensor(37, dtype=torch.int32,
                                                  device=dev))
                            if hd == 64 else (ragged,)):
                    what = (f"K8 {dtype} hd {hd} views{' +1' if odd else ''}"
                            f" pos0 {'ragged' if pos.dim() else int(pos)}")
                    same(lambda c: kd.write_kv_block(c, kv[0], pos),
                         lambda c: kd.write_kv_block_plain(c, kv[0], pos),
                         caches[0], what)
                    _same_pair(kd.write_kv_block, kd.write_kv_block_plain,
                               caches, kv, (pos,), what + " pair")
                    n += 1
                    if dtype == torch.int8 and hd == 64:
                        _same_pair(kd.write_kv_block,
                                   kd.write_kv_block_plain, scales, srows,
                                   (pos,), what + " scale pair")
                        n += 1
    kv = _proj_views((b,), T, 16, 64, torch.bfloat16, gen, dev)
    caches = [torch.randn(b, 16, 64, L, generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2)]
    _same_repeats(kd.write_kv_block, caches, kv, (ragged,),
                  "K8 bf16 views pair")
    # K7 from the decode step's views (16-byte loads along hd, and one
    # element off: scalar loads) and from contiguous rows, single and pair
    # form, at hd 1 (the scale sidecars' view) and 16-128; per-row
    # positions with drops past the end and below 0, and shared ones
    rpos = torch.randint(0, L, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    rpos[:3] = torch.tensor([L, L + 999, -5], device=dev)
    shared = [torch.tensor(x, dtype=torch.int32, device=dev)
              for x in (37, L, -1)]
    for dtype in (torch.bfloat16, torch.int8, torch.float32):
        for hd in (1, 16, 32, 64, 128):
            if dtype == torch.int8:
                caches = [torch.randint(-127, 128, (b, 16, hd, L),
                                        generator=gen, device=dev,
                                        dtype=torch.int8) for _ in range(2)]
            else:
                caches = [torch.randn(b, 16, hd, L, generator=gen,
                                      device=dev).to(dtype) for _ in range(2)]
            for layout in ("view", "misaligned", "contiguous"):
                kv = _row_views(b, 16, hd, dtype, gen, dev,
                                layout == "misaligned")
                if layout == "contiguous":
                    kv = tuple(x.contiguous() for x in kv)
                for pos in [rpos] + shared:
                    what = (f"K7 {dtype} hd {hd} {layout} rows, pos "
                            f"{'per row' if pos.dim() else int(pos)}")
                    same(lambda c: kd.write_kv_row(c, kv[0], pos),
                         lambda c: kd.write_kv_row_plain(c, kv[0], pos),
                         caches[0], what)
                    _same_pair(kd.write_kv_row, kd.write_kv_row_plain,
                               caches, kv, (pos,), what + " pair")
                    n += 1
    kv = _row_views(b, 16, 64, torch.bfloat16, gen, dev)
    caches = [torch.randn(b, 16, 64, L, generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2)]
    _same_repeats(kd.write_kv_row, caches, kv, (rpos,), "K7 bf16 views pair")
    print(f"[k7/k8] {n} cases (bf16/int8/f32 caches and f32 scale "
          f"sidecars, batch 32 x L 1088, ragged and scalar pos incl. out of "
          f"range, T 64 blocks straddling the end; K8 from the projection's "
          f"views at hd 16-128 (16-byte loads) and one element off (scalar "
          f"loads), single and k/v pair (one launch), and the int8 scale "
          f"pair; K7 from the decode step's views at hd 1-128, one element "
          f"off and contiguous, single and pair (one launch), positions "
          f"per row and shared, past the end and negative) bit-identical to "
          f"the plain versions; the bf16 views pairs 50 times over, the "
          f"same bits")

    out = {"K7": time_k7(dev, gen), "K8": time_k8(dev, gen)}
    lc = {x: torch.zeros(1, 16, 64, 256, device=dev, dtype=torch.bfloat16)
          for x in "kv"}
    kv = _proj_views((1,), 64, 16, 64, torch.bfloat16, gen, dev)
    p0 = torch.tensor(64, dtype=torch.int32, device=dev)
    _one_launch(lambda: G._write_block(lc, kv[0].transpose(2, 3),
                                       kv[1].transpose(2, 3), p0),
                kd.write_kv_block, "write_block_kernel", "K8")
    # the decode step's k/v write: one K7 launch and no copy; an int8
    # layer's write is two launches (k with v, ks with vs)
    lc = {x: torch.zeros(b, 16, 64, L, device=dev, dtype=torch.bfloat16)
          for x in "kv"}
    kv = _row_views(b, 16, 64, torch.bfloat16, gen, dev)
    _one_launch(lambda: G._write_rows(lc, kv[0], kv[1], rpos),
                kd.write_kv_row, "write_row_kernel", "K7")
    lc8 = {x: torch.zeros(b, 16, 64, L, device=dev, dtype=torch.int8)
           for x in "kv"}
    lc8.update({x: torch.zeros(b, 16, L, device=dev) for x in ("ks", "vs")})
    before = kd.write_kv_row.launches
    G._write_rows(lc8, kv[0], kv[1], rpos)
    check(kd.write_kv_row.launches == before + 2,
          f"an int8 layer's row write took "
          f"{kd.write_kv_row.launches - before} K7 launches, not 2")
    for name, shape, st, what in (
            ("K7", "rows (32, 16, 64) from the decode step's view into "
                   "(32, 16, 64, 1088)", out["K7"],
             "rows read + bytes written"),
            ("K8", "block (1, 16, 64, 64) from the projection's view into "
                   "(1, 16, 64, 256)", out["K8"],
             "rows read + bytes written")):
        _print_write_times(name, shape, st, what)
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
    pages of 256, each against its plain version at SPLIT_K at K6's
    tolerance (rtol 1e-3 / atol 2e-3: shared tile and split partition and
    bf16 roundings, another f32 summation order). The bit gates
    (``_attend_bits``) at T = 4 over rows crossing split edges, bf16 and
    int8. Then K9 on pages holding a dense cache's columns against K6 on
    that cache: equal bit for bit, one launch a call. Times K9 (events
    and device time), its plain version and K6 on the equivalent dense
    cache (the yardstick of the indirection's cost); no single PyTorch
    call computes paged attention, so there is no library figure."""
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
          f"within rtol 1e-3 / atol 2e-3 of the plain version at SPLIT_K; "
          f"max |err| {worst:.3g}")
    for kind in ("bf16", "int8"):
        b, nkv, ps, mp = 32, 16, 128, 9
        P = b * mp + 1
        table = table_of(b, mp, P)
        k, v, ks, vs = pools(P, nkv, ps, kind)
        q = torch.randn(b, 4, 16, 64, generator=gen,
                        device=dev).to(torch.bfloat16)
        _attend_bits(lambda q_, p_: kd.paged_flash_decode(
            q_, k, v, table, p_, 0.125, ks, vs), q,
            _split_edges(b, 4, L, gen, dev), f"K9 {kind}")
    print("[k9] bit gates: row t of T = 4 equals T = 1 at pos + t, 50 repeat "
          "launches equal, q from the projection's view equals its copy "
          "(bf16 and int8 pools, 289 pages of 128, rows across split edges)")

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
        t = [_attend_device_ms(fn, counted, paged, f"{name} {kind}")
             for fn, counted, paged, name in (
                 (k9_fn, kd.paged_flash_decode, True, "K9"),
                 (k6_fn, kd.flash_block_decode, False, "K6"),
                 (k6_fn, kd.flash_block_decode, False, "K6"),
                 (k9_fn, kd.paged_flash_decode, True, "K9"))]
        kern_dev, dense_dev = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        plain = time_ms(lambda: kd.paged_flash_decode_plain(
            q, paged["k"], paged["v"], table, pos, 0.125, paged.get("ks"),
            paged.get("vs")), iters=5)
        nbytes = (_live_bytes(pos, 1, L, nkv, 64, kc.element_size(),
                              ksc is not None)
                  + table.numel() * 4 + pos.numel() * 4
                  + q.numel() * 2 + q.numel() * 4)
        bound = nbytes / PEAK_HBM_BYTES_S * 1e3
        out[kind] = dict(ms=kern, device_ms=kern_dev, plain_ms=plain,
                         library_ms=None, bound_ms=bound, bound_by="bytes",
                         k6_ms=dense_ms, k6_device_ms=dense_dev)
        print(f"[k9] T=1 batch 32 x 16 kv heads, 289 pages of 128, ragged "
              f"pos {kind} pools: kernel {kern:.4f} ms by events, "
              f"{kern_dev:.5f} ms device; K6 on the same columns dense "
              f"{dense_ms:.4f} / {dense_dev:.5f} ms (K9 / K6 "
              f"{kern_dev / dense_dev:.3f} by device time), plain "
              f"{plain:.4f} ms, bound {bound:.4f} ms "
              f"({nbytes} B live cache + table + q + out / 3.35 TB/s), "
              f"kernel at {100 * bound / kern_dev:.1f}% of bound by device "
              f"time; max |K9 - K6| {same[kind]}")
    out["bf16"]["max_abs_err"] = worst
    out["bf16"]["k6_equal_max_abs_err"] = max(same.values())
    return out


def phase_page_writes(dev) -> dict:
    """K10 and K11 bit-identical to their plain versions, the drop
    sentinels included (off = ps, a negative off, pads past n_valid, a
    page past the pool), on bf16/int8/f32 pools and the f32 scale pools'
    (P, kvh, 1, ps) view; K11 also from the projection's views and in
    the pair form; then their times at the serving path's shapes, by
    events and by device time, beside indexed assignment's."""
    import torch
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.models import paged as PG

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
    # K11 from the path's views (16-byte loads along hd, and one element
    # off: scalar loads), single and pair form; int8 with the scale pools'
    # pair through (P, kvh, 1, ps); hd 16-128 from the views
    chunks = ((3, 0, ps, ps), (4, 5, 100, ps), (5, -7, 64, 64),
              (6, ps - 24, 24, 40), (P + 3, 8, 0, 32))
    for dtype in (torch.bfloat16, torch.int8, torch.float32):
        for hd in (16, 32, 64, 128):
            if dtype == torch.int8:
                pools = [torch.randint(-127, 128, (P, 16, hd, ps),
                                       generator=gen, device=dev,
                                       dtype=torch.int8) for _ in range(2)]
            else:
                pools = [torch.randn(P, 16, hd, ps, generator=gen,
                                     device=dev).to(dtype) for _ in range(2)]
            scales = [torch.rand(P, 16, 1, ps, generator=gen, device=dev)
                      for _ in range(2)]
            for odd in ((False, True) if hd == 64 else (False,)):
                for pg, o0, nv, T in (chunks if hd == 64 else chunks[:2]):
                    kv = _proj_views((), T, 16, hd, dtype, gen, dev, odd)
                    what = (f"K11 {dtype} hd {hd} views"
                            f"{' +1' if odd else ''} page {pg} off0 {o0} "
                            f"n_valid {nv} T {T}")
                    same(lambda t: kd.write_kv_page_block(t, kv[0], pg, o0,
                                                          nv),
                         lambda t: kd.write_kv_page_block_plain(
                             t, kv[0], pg, o0, nv), pools[0], what)
                    _same_pair(kd.write_kv_page_block,
                               kd.write_kv_page_block_plain, pools, kv,
                               (pg, o0, nv), what + " pair")
                    n += 1
                    if dtype == torch.int8 and hd == 64:
                        srows = _proj_views((), T, 16, 1, torch.float32, gen,
                                            dev)
                        _same_pair(kd.write_kv_page_block,
                                   kd.write_kv_page_block_plain, scales,
                                   srows, (pg, o0, nv), what + " scale pair")
                        n += 1
    kv = _proj_views((), 100, 16, 64, torch.bfloat16, gen, dev)
    pools = [torch.randn(P, 16, 64, ps, generator=gen,
                         device=dev).to(torch.bfloat16) for _ in range(2)]
    _same_repeats(kd.write_kv_page_block, pools, kv, (6, 11, 100),
                  "K11 bf16 views pair")
    # K10 from the decode step's views (16-byte loads along hd, and one
    # element off: scalar loads) and from contiguous rows, single and pair
    # form, at hd 1 (the scale pools' view), 16-128; per-row pages and
    # lanes with the sentinels and two rows on one page; and one page
    # shared by every row (0-d), each in its own lane
    rows_page = page.clone()
    rows_page[7] = rows_page[8]               # two rows on one page
    rows_off = off.clone()
    rows_off[7], rows_off[8] = 5, ps - 1
    shared = (torch.tensor(P - 2, dtype=torch.int32, device=dev),
              (torch.arange(b, device=dev) * 4 - 1).to(torch.int32))
    for dtype in (torch.bfloat16, torch.int8, torch.float32):
        for hd in (1, 16, 32, 64, 128):
            if dtype == torch.int8:
                pools = [torch.randint(-127, 128, (P, 16, hd, ps),
                                       generator=gen, device=dev,
                                       dtype=torch.int8) for _ in range(2)]
            else:
                pools = [torch.randn(P, 16, hd, ps, generator=gen,
                                     device=dev).to(dtype) for _ in range(2)]
            for layout in ("view", "misaligned", "contiguous"):
                kv = _row_views(b, 16, hd, dtype, gen, dev,
                                layout == "misaligned")
                if layout == "contiguous":
                    kv = tuple(x.contiguous() for x in kv)
                for pg, of in ((rows_page, rows_off), shared):
                    what = (f"K10 {dtype} hd {hd} {layout} rows, "
                            f"{'per-row pages' if pg.dim() else 'one page'}")
                    same(lambda t: kd.write_kv_page_row(t, kv[0], pg, of),
                         lambda t: kd.write_kv_page_row_plain(t, kv[0], pg,
                                                              of),
                         pools[0], what)
                    _same_pair(kd.write_kv_page_row,
                               kd.write_kv_page_row_plain, pools, kv,
                               (pg, of), what + " pair")
                    n += 1
    kv = _row_views(b, 16, 64, torch.bfloat16, gen, dev)
    pools = [torch.randn(P, 16, 64, ps, generator=gen,
                         device=dev).to(torch.bfloat16) for _ in range(2)]
    _same_repeats(kd.write_kv_page_row, pools, kv, (rows_page, rows_off),
                  "K10 bf16 views pair")
    print(f"[k10/k11] {n} cases (bf16/int8/f32 pools of 289 pages x 16 kv "
          f"heads x 64 x 128 and f32 scale pools; off = ps, -1, a page past "
          f"the pool; chunks with pads, at the page edge, from a negative "
          f"start, off the 16-byte lanes, n_valid 0; K11 from the "
          f"projection's views at hd 16-128 (16-byte loads) and one element "
          f"off (scalar loads), single and k/v pair (one launch), and the "
          f"int8 scale pair; K10 from the decode step's views at hd 1-128, "
          f"one element off and contiguous, single and pair (one launch), "
          f"two rows on one page, per-row pages and one shared) bit-identical "
          f"to the plain versions; the bf16 views pairs 50 times over, the "
          f"same bits")

    out = {"K10": time_k10(dev, gen), "K11": time_k11(dev, gen)}
    entry = {"k": pools[0], "v": pools[1]}
    _one_launch(lambda: PG.paged_write_rows(entry, kv[0], kv[1], None, None,
                                            rows_page, rows_off),
                kd.write_kv_page_row, "write_row_kernel", "K10")
    kv = _proj_views((), ps, 16, 64, torch.bfloat16, gen, dev)
    pg, o0, nv = (torch.tensor([x], dtype=torch.int32, device=dev)
                  for x in (17, 0, ps))
    _one_launch(lambda: PG.paged_write_chunk(entry, kv[0], kv[1], None, None,
                                             pg, o0, nv),
                kd.write_kv_page_block, "write_block_kernel", "K11")
    for name, shape, st in (("K10", "rows (32, 16, 64) from the decode "
                                    "step's view into 289 pages of (16, 64,"
                                    " 128)", out["K10"]),
                            ("K11", "chunk (16, 64, 128) from the "
                                    "projection's view into one page",
                             out["K11"])):
        _print_write_times(name, shape, st, "rows read + bytes written")
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


def paged_beside_dense(params, cfg, prompt, steps, gen, ps=128) -> dict:
    """A dense prefill of ``prompt`` (b, plen) copied into permuted pages
    of ``ps``, then ``steps`` teacher-forced ``paged_decode_step``s
    beside ``decode_step``: greedy tokens equal at every step. Returns
    the page count, the largest logit difference and the median step
    times."""
    import torch
    from rlo_tpu_torch.models import generate as G
    from rlo_tpu_torch.models import paged as PG

    dev = prompt.device
    b, plen = prompt.shape
    L = plen + steps
    mp = -(-L // ps)
    P = b * mp + 1
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
    return dict(pages=P, steps=steps, max_abs_logit_diff=dmax,
                dense_ms_per_step=statistics.median(dense_ms),
                paged_ms_per_step=statistics.median(paged_ms))


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
    from rlo_tpu_torch.models import serve as S
    from rlo_tpu_torch.models.transformer import (TransformerConfig,
                                                  cast_params, init_params)
    from rlo_tpu_torch.utils.metrics import Registry

    out = {}
    cfg = TransformerConfig(**SERVE_CFG)
    params = cast_params(init_params(cfg, seed=SEED, device=dev),
                         cfg.act_dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    b, plen, steps = PAGED_TF["batch"], PAGED_TF["plen"], PAGED_TF["steps"]
    prompt = torch.randint(0, cfg.vocab, (b, plen), generator=gen,
                           device=dev, dtype=torch.int32)
    out["teacher_forced"] = tf = paged_beside_dense(params, cfg, prompt,
                                                    steps, gen)
    print(f"[paged] teacher-forced batch {b}, plen {plen}, {steps} steps, "
          f"{tf['pages']} pages of 128 (permuted): greedy tokens equal at "
          f"every step, max |paged - dense logit| "
          f"{tf['max_abs_logit_diff']}; median step dense "
          f"{tf['dense_ms_per_step']:.3f} ms, paged "
          f"{tf['paged_ms_per_step']:.3f} ms")
    ps = 128

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
    |value|: f32 sums of up to 1024 products in another order. Then
    every bf16 head dim, and the training cell's GQA fold at D 128 cut to
    L 512 (dead query tiles inside K5's causal spans), with K5's prepass
    held bit-equal to its plain version."""
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
    # tensor cores) against their plain versions, each side on its own m';
    # K5's prepass bit-equal to its plain twin, one launch a K5 launch.
    # (heads, D, groups, rows a group, Lk): the last is the training
    # cell's GQA fold at D 128 cut to L 512, positions repeating 12 times
    # along Lq, so each 128-key block past the first has dead query tiles
    # inside its causal span
    shapes = [(8, dd, 1, lq, lk) for dd in (16, 32, 128)
              for lq, lk in ((33, 7), (129, 77), (256, 256))]
    shapes.append((16, 128, 12, 512, 512))
    n_dims = 0
    for hh, dd, groups, lq, lk in shapes:
        nq = groups * lq
        q, k, v = (torch.randn(hh, ll, dd, generator=gen,
                               device=dev).to(torch.bfloat16)
                   for ll in (nq, lk, lk))
        m = torch.full((hh, 1, nq), kf.NEG, device=dev)
        state = (m, torch.zeros_like(m), torch.zeros(hh, nq, dd,
                                                     device=dev))
        qp = torch.arange(lk - lq, lk, dtype=torch.int32,
                          device=dev).repeat(groups).reshape(1, nq)
        kp = torch.arange(lk, dtype=torch.int32, device=dev).reshape(1, lk)
        dl2, do2, route = rand(hh, 1, nq), rand(hh, nq, dd), rand(hh, 1, nq)
        prep = kf.bwd_dkv_prep(do2, qp)
        check(all(torch.equal(a, b) for a, b in
                  zip(prep, kf.bwd_dkv_prep_plain(do2, qp))),
              f"K5's prepass differs from its plain version (D={dd}, "
              f"{groups} x {lq} x {lk})")
        for causal in (True, False):
            what = (f"bf16, D={dd}, {groups} x {lq} x {lk}, "
                    f"causal={causal}")
            kw = dict(causal=causal, scale=scale)
            with torch.no_grad():
                m2 = kf.flash_block_update_hld(q, k, v, *state, qp, kp,
                                               **kw)[0]
                m2p = kf.flash_block_update_hld_plain(q, k, v, *state,
                                                      qp, kp, **kw)[0]
            cnt = kf.rowstats(q, k, m2, qp, kp, **kw)
            check(bool((cnt >= 1).all()),
                  f"K3 found no tie with K2's m' on some row ({what})")
            ops = (q, k, v, m2, dl2, do2, route, qp, kp)
            pops = (q, k, v, m2p, dl2, do2, route, qp, kp)
            before = (kf.bwd_dkv.launches, kf.bwd_dkv_prep.launches)
            got = (kf.bwd_dq(*ops, **kw), *kf.bwd_dkv(*ops, **kw))
            check((kf.bwd_dkv.launches - before[0],
                   kf.bwd_dkv_prep.launches - before[1]) == (1, 1),
                  f"K5 and its prepass launched "
                  f"{kf.bwd_dkv.launches - before[0]} and "
                  f"{kf.bwd_dkv_prep.launches - before[1]} times, not once "
                  f"each ({what})")
            want = (kf.bwd_dq_plain(*pops, **kw),
                    *kf.bwd_dkv_plain(*pops, **kw))
            torch.cuda.synchronize()
            for name, g, w, key in zip(("dq", "dk", "dv"), got, want,
                                       (4, 5, 5)):
                check(bool(torch.isfinite(g).all()) and
                      _close(g, w, 1e-4, 1e-4),
                      f"K{key} {name} differs from its plain version "
                      f"({what})")
                worst[key] = max(worst[key], abs_err(g, w))
            n_dims += 1
    print(f"[k3-k5] bf16 at D 16/32/128 (33 x 7, 129 x 77, 256 x 256) and "
          f"the GQA fold at D 128 (16 heads, 12 x 512 x 512), causal and "
          f"not; {n_dims} cases: K3 ties K2's m' on every row; K4/K5 within "
          f"rtol 1e-4 of the plain versions; K5's prepass equals its plain "
          f"version, one launch a K5 launch; max |err| K4 {worst[4]:.3g}, "
          f"K5 {worst[5]:.3g}")

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
        dev_ms = device_ms(kern, 50)
        plain_ms = time_ms(plain, iters=5)
        bound, by = _bwd_bound(which, h, n, n, d, 2, pairs)
        stats[f"K{which}"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                  library_ms=library, bound_ms=bound,
                                  bound_by=by, max_abs_err=worst[which])
        print(f"[k3-k5] K{which} causal {h} heads x {n} x 64 bf16: kernel "
              f"{ms:.4f} ms a launch in runs of 10, {dev_ms:.5f} ms device, "
              f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"kernel at {100 * bound / dev_ms:.1f}% of bound by device "
              f"time ({100 * bound / ms:.1f}% by events)")
    k45 = stats['K4']['ms'] + stats['K5']['ms']
    print(f"[k3-k5] scaled_dot_product_attention backward at the same "
          f"shape (the yardstick of K4+K5, {k45:.4f} ms): device {lib:.4f} "
          f"ms by the profiler ({k45 / lib:.2f}x), {lib_events:.4f} ms a "
          f"call in runs of 10 by CUDA events (host time included)")
    return stats


def time_k3(dev) -> dict:
    """K3 alone at the training shape (``BWD_SHAPE`` folded heads x L x
    64, bf16, from the initial state), causal and not: CUDA-event ms a
    launch in runs of 10 and device ms by the profiler, beside the bound,
    and a digest of the counts (equal digests: equal counts). Calls only
    what the parent tree has too (``--time-k3``)."""
    import hashlib
    import torch
    from rlo_tpu_torch.kernels import flash as kf
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    h, n = BWD_SHAPE
    q, k, v = (torch.randn(h, n, 64, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    m = torch.full((h, 1, n), kf.NEG, device=dev)
    state = (m, torch.zeros_like(m), torch.zeros(h, n, 64, device=dev))
    pos = torch.arange(n, dtype=torch.int32, device=dev).reshape(1, n)
    out = {}
    for causal in (True, False):
        kw = dict(causal=causal, scale=0.125)
        with torch.no_grad():
            m2 = kf.flash_block_update_hld(q, k, v, *state, pos, pos,
                                           **kw)[0]
        f = lambda: kf.rowstats(q, k, m2, pos, pos, **kw)  # noqa: E731
        cnt = f()
        pairs = h * (n * (n + 1) // 2 if causal else n * n)
        bound, by = _bwd_bound(3, h, n, n, 64, 2, pairs)
        out["causal" if causal else "non-causal"] = dict(
            ms=time_ms(f, iters=10, per=10), device_ms=device_ms(f, 50),
            bound_ms=bound, bound_by=by,
            counts_sha1=hashlib.sha1(cnt.cpu().numpy().tobytes())
            .hexdigest()[:12])
    return out


def time_flash(dev) -> dict:
    """K2 at the prefill shape (512 folded heads x 1024 x 64, bf16,
    causal, from the initial state) and K4/K5 at the training shape
    (``BWD_SHAPE``, bf16, causal, fast mode: route 0): CUDA-event ms a
    launch in runs of 10 and device ms by the profiler, with a digest of
    each output (equal digests: equal bits); then K4/K5 at the training
    cell's shape (``CELL_BWD``), each beside its bound (``_bwd_bound``:
    3 or 4 products) and its executed rate (5 or 8 bf16 products of the
    split precision over the device time); then K5 at the training
    shape with D 16 and 32. Calls only what the parent tree has too
    (``--time-flash``)."""
    import hashlib
    import torch
    from rlo_tpu_torch.kernels import flash as kf

    def digest(*ts):
        h = hashlib.sha1()
        for t in ts:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:12]

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    out = {}
    for tag, (h, n) in (("K2 prefill", (512, 1024)), ("K4/K5", BWD_SHAPE)):
        q, k, v = (torch.randn(h, n, 64, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        m = torch.full((h, 1, n), kf.NEG, device=dev)
        state = (m, torch.zeros_like(m), torch.zeros(h, n, 64, device=dev))
        pos = torch.arange(n, dtype=torch.int32, device=dev).reshape(1, n)
        kw = dict(causal=True, scale=0.125)
        with torch.no_grad():
            fwd = lambda: kf.flash_block_update_hld(  # noqa: E731
                q, k, v, *state, pos, pos, **kw)
            m2 = fwd()
        if tag == "K2 prefill":
            out[tag] = dict(ms=time_ms(fwd, iters=10, per=10),
                            device_ms=device_ms(fwd, 20), sha1=digest(*m2))
            continue
        dl2, do2 = (torch.randn(h, 1, n, generator=gen, device=dev),
                    torch.randn(h, n, 64, generator=gen, device=dev))
        ops = (q, k, v, m2[0], dl2, do2, torch.zeros_like(dl2), pos, pos)
        for name, f in (("K4", lambda: kf.bwd_dq(*ops, **kw)),
                        ("K5", lambda: kf.bwd_dkv(*ops, **kw))):
            r = f()
            out[name] = dict(ms=time_ms(f, iters=10, per=10),
                             device_ms=device_ms(f, 20),
                             sha1=digest(*(r if isinstance(r, tuple)
                                           else (r,))))
    # the training cell's shape (sc2-3b-train-4k): 16 folded KV heads,
    # 12 query heads a group over positions 0..4095, Lk 4096, D 128
    h, groups, n, d = CELL_BWD
    lq = groups * n
    q = torch.randn(h, lq, d, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(h, n, d, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    kpos = torch.arange(n, dtype=torch.int32, device=dev).reshape(1, n)
    qpos = kpos.repeat(1, groups)
    m = torch.full((h, 1, lq), kf.NEG, device=dev)
    state = (m, torch.zeros_like(m), torch.zeros(h, lq, d, device=dev))
    kw = dict(causal=True, scale=d ** -0.5)
    with torch.no_grad():
        m2 = kf.flash_block_update_hld(q, k, v, *state, qpos, kpos, **kw)[0]
    dl2, do2 = (torch.randn(h, 1, lq, generator=gen, device=dev),
                torch.randn(h, lq, d, generator=gen, device=dev))
    ops = (q, k, v, m2, dl2, do2, torch.zeros_like(dl2), qpos, kpos)
    pairs = h * groups * n * (n + 1) // 2
    for name, which, runs, f in (
            ("K4 cell", 4, 5, lambda: kf.bwd_dq(*ops, **kw)),
            ("K5 cell", 5, 8, lambda: kf.bwd_dkv(*ops, **kw))):
        r = f()
        dms = device_ms(f, 5)
        bound, by = _bwd_bound(which, h, lq, n, d, 2, pairs)
        out[name] = dict(ms=time_ms(f, iters=5, per=2), device_ms=dms,
                         bound_ms=bound, bound_by=by,
                         executed_tflops=runs * 2 * d * pairs / dms / 1e9,
                         sha1=digest(*(r if isinstance(r, tuple)
                                       else (r,))))
    # K5 at the training shape's heads and length at the small head dims
    h, n = BWD_SHAPE
    pos = torch.arange(n, dtype=torch.int32, device=dev).reshape(1, n)
    for d in (16, 32):
        q, k, v = (torch.randn(h, n, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        m = torch.full((h, 1, n), kf.NEG, device=dev)
        state = (m, torch.zeros_like(m), torch.zeros(h, n, d, device=dev))
        kw = dict(causal=True, scale=d ** -0.5)
        with torch.no_grad():
            m2 = kf.flash_block_update_hld(q, k, v, *state, pos, pos,
                                           **kw)[0]
        dl2, do2 = (torch.randn(h, 1, n, generator=gen, device=dev),
                    torch.randn(h, n, d, generator=gen, device=dev))
        ops = (q, k, v, m2, dl2, do2, torch.zeros_like(dl2), pos, pos)
        f = lambda: kf.bwd_dkv(*ops, **kw)  # noqa: E731
        r = f()
        bound, by = _bwd_bound(5, h, n, n, d, 2, h * n * (n + 1) // 2)
        out[f"K5 D{d}"] = dict(ms=time_ms(f, iters=10, per=10),
                               device_ms=device_ms(f, 20), bound_ms=bound,
                               bound_by=by, sha1=digest(*r))
    return out


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
#: K4/K5 at the training cell's shape: (folded KV heads, GQA group, L, D)
CELL_BWD = (16, 12, 4096, 128)
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


# ---------------------------------------------------------------------------
# Phase 11: speculative decoding at full width
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


#: the draft of benchmarks/spec_bench.py:288-293 beside the flagship
#: target, and its run (spec_bench's batch 8 and plen 256)
SPEC_DRAFT = dict(vocab=32768, d_model=512, n_heads=8, n_layers=2,
                  d_ff=2048, dtype="bfloat16")
SPEC_RUN = dict(batch=8, plen=256, max_new=64, gamma=4)
#: the perturbed draft's noise, times each weight tensor's spread: the
#: reference's 0.03 absolute (tests/test_speculative.py:60-69) exceeds
#: the flagship's embedding scale and no proposal is ever accepted
SPEC_NOISE = 0.3


@contextlib.contextmanager
def _recording_picks(SP, cfg):
    """For the duration, every ``decode_step`` (the draft's) and
    ``block_decode`` (the verify's) that ``speculative_generate`` calls
    records its greedy picks and their top-2 gaps on the host."""
    import torch
    rec = {"draft": [], "verify": []}
    orig = SP.decode_step, SP.block_decode

    def note(kind, logits):
        flat = logits.reshape(-1, logits.shape[-1])
        rec[kind].append((
            torch.argmax(flat, -1).reshape(logits.shape[:-1]).cpu().numpy(),
            top2_gap(flat, cfg).reshape(logits.shape[:-1]).float().cpu()
            .numpy()))

    def draft_step(*a, **kw):
        logits, cache = orig[0](*a, **kw)
        note("draft", logits)
        return logits, cache

    def verify(*a, **kw):
        logits, cache = orig[1](*a, **kw)
        note("verify", logits)
        return logits, cache

    SP.decode_step, SP.block_decode = draft_step, verify
    try:
        yield rec
    finally:
        SP.decode_step, SP.block_decode = orig


def _partings(rec, gamma, max_new):
    """Replay a greedy run's acceptance from its recorded picks: the
    (round, row, gap) of each row still short of ``max_new`` whose draft
    pick parted from the verify's before the last proposal (a
    rejection), with the verify's scaled top-2 gap there."""
    import numpy as np
    d = [rec["draft"][r * gamma:(r + 1) * gamma]
         for r in range(len(rec["verify"]))]
    n_out, out = None, []
    for r, (t_pick, t_gap) in enumerate(rec["verify"]):
        d_pick = np.stack([p for p, _ in d[r]], axis=1)      # (b, gamma)
        if n_out is None:
            n_out = np.ones(len(t_pick), np.int64)
        acc = np.cumprod(d_pick == t_pick, axis=1).sum(axis=1)
        for row in np.nonzero(n_out < max_new)[0]:
            if acc[row] < gamma - 1:
                out.append((r, int(row), float(t_gap[row, acc[row]])))
        n_out = np.where(n_out < max_new,
                         np.minimum(n_out + np.minimum(acc, gamma - 1) + 1,
                                    max_new), n_out)
    return out


def phase_speculative(dev, counted) -> dict:
    """Speculative decoding at full width: the flagship target with
    spec_bench's draft, batch 8, plen 256, 64 new tokens, gamma 4,
    random weights from the seed; three drafts (the random draft, the
    target itself, the target plus seeded noise). Greedy tokens equal
    the port's ``generate`` on the same prompt up to a near-tie; the
    self-draft takes ceil((max_new - 1) / gamma) rounds unless a near-tie
    parted draft and verify (every parting at one). ``counted`` (K6, K7,
    K8) are set to 0 just before the three runs and read just after:
    each must have run. Tokens per round and ms per emitted token beside
    ``generate``'s are figures, not gates."""
    import torch
    from rlo_tpu_torch.models import generate as G
    from rlo_tpu_torch.models import speculative as SP
    from rlo_tpu_torch.models.transformer import (TransformerConfig,
                                                  cast_params, init_params)

    cfg, dcfg = TransformerConfig(**SERVE_CFG), TransformerConfig(**SPEC_DRAFT)
    b, plen, max_new, gamma = (SPEC_RUN[k] for k in ("batch", "plen",
                                                      "max_new", "gamma"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    f32 = init_params(cfg, seed=SEED, device=dev)
    noisy = cast_params(_tree_map(lambda p: p + SPEC_NOISE * p.std() *
                                  torch.randn(p.shape, generator=gen,
                                              device=dev), f32),
                        cfg.act_dtype)
    params = cast_params(f32, cfg.act_dtype)
    del f32
    drafts = {"random": (cast_params(init_params(dcfg, seed=SEED + 14,
                                                 device=dev), dcfg.act_dtype),
                         dcfg),
              "self": (params, cfg), "perturbed": (noisy, cfg)}
    prompt = torch.randint(0, cfg.vocab, (b, plen), generator=gen,
                           device=dev, dtype=torch.int32)
    want, gaps = greedy_with_gaps(params, prompt, cfg, max_new)
    check(bool((G.generate(params, prompt, cfg, max_new=max_new).cpu()
                .numpy() == want).all()),
          "greedy_with_gaps differs from generate")

    out, runs = {}, {}
    for fn in counted:
        fn.launches = 0
    for name, (dp, dc) in drafts.items():
        with _recording_picks(SP, cfg) as rec:
            toks, rounds = SP.speculative_generate(
                params, dp, prompt, cfg, dc, max_new=max_new, gamma=gamma,
                return_rounds=True)
        runs[name] = (toks.cpu().numpy(), rounds, rec)
    launches = {fn.__name__: fn.launches for fn in counted}
    for fn in counted:
        check(launches[fn.__name__] > 0,
              f"{fn.__name__} was not launched by speculative decoding")

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    gen_ms = timed(lambda: G.generate(params, prompt, cfg, max_new=max_new))
    expected = -(-(max_new - 1) // gamma)
    for name, (toks, rounds, rec) in runs.items():
        compared = [compare_until_near_tie(toks[i], want[i], gaps[i])
                    for i in range(b)]
        parted = _partings(rec, gamma, max_new)
        if name == "self":    # the same model: it parts only at near-ties
            for r, row, gap in parted:
                check(gap < NEAR_TIE, f"the self-draft parts from the verify "
                                      f"in round {r}, row {row}, away from a "
                                      f"near-tie (scaled top-2 gap {gap:.4g})")
            check(rounds == expected or parted,
                  f"the self-draft took {rounds} rounds, not {expected}, "
                  f"and no near-tie parted draft and verify")
        dp, dc = drafts[name]
        ms = timed(lambda: SP.speculative_generate(
            params, dp, prompt, cfg, dc, max_new=max_new, gamma=gamma))
        out[name] = dict(
            rounds=rounds, tokens_per_round=(max_new - 1) / rounds,
            rejections=len(parted), positions_equal=[c[0] for c in compared],
            compared_to_end=sum(c[1] for c in compared),
            ms=ms, ms_per_token=ms / max_new)
        print(f"[spec] {name} draft: {rounds} rounds ({(max_new - 1) / rounds:.2f}"
              f" tokens a round a row after the first), {len(parted)} "
              f"(round, row) rejections before the last proposal"
              f"{' (near-tie partings)' if name == 'self' else ''}; tokens equal "
              f"generate's, {out[name]['compared_to_end']} of {b} rows to "
              f"the end (equal positions {out[name]['positions_equal']}, "
              f"any parting at a near-tie); {ms:.1f} ms, "
              f"{ms / max_new:.3f} ms per emitted token against generate's "
              f"{gen_ms / max_new:.3f}")
    out["generate_ms"], out["launches"] = gen_ms, launches
    print(f"[spec] target {SERVE_CFG['d_model']} wide x "
          f"{SERVE_CFG['n_layers']} layers, draft {SPEC_DRAFT['d_model']} x "
          f"{SPEC_DRAFT['n_layers']}, batch {b}, plen {plen}, {max_new} new, "
          f"gamma {gamma}: the self-draft's rounds {runs['self'][1]} (expected "
          f"{expected} without near-tie partings); launches of the three runs "
          f"{json.dumps(launches)}")
    return out


# ---------------------------------------------------------------------------
# Phase 12: MoE layers on one card at full width
# ---------------------------------------------------------------------------

#: the flagship's widths with 8 experts (capacity factor 2.0, aux
#: coefficient 1e-2: the config's defaults)
MOE_EXPERTS = 8
#: phase 12's serving runs: generate and the teacher-forced paged steps
MOE_SERVE = dict(batch=32, plen=1024, max_new=16)


@contextlib.contextmanager
def _routing_counts(M):
    """For the duration, every ``route`` call adds its (kept, routed)
    token counts, as device tensors, to the list it yields."""
    seen, orig = [], M.route

    def route(*a, **kw):
        r = orig(*a, **kw)
        seen.append((r[4].sum(), r[4].numel()))
        return r

    M.route = route
    try:
        yield seen
    finally:
        M.route = orig


def phase_moe(dev, flash_fns) -> dict:
    """MoE layers at full width: the flagship's widths with 8 experts.
    Training on one batch of 4 x 1024 from the seed (K2, K4, K5 through
    'pallas_fast'): the loss and grads against the same step with the
    attention backward in 'xla' mode (losses equal, grads within
    GRAD_REL_LIMIT), the aux term finite and > 0, 10 SGD steps with the
    loss falling; the share of tokens dropped, the median step, tokens/s,
    peak memory, launches per step, and the step with the sorted
    dispatch forced (the kept rows only, a host read a layer) beside it.
    Serving at capacity_factor = n_experts (drop-free everywhere):
    ``generate`` at batch 32 / plen 1024 / 16 new (timed in bf16), in f32
    against the argmax of a teacher-forced f32 ``forward`` over prompt +
    output; a 16-request dense f32 ``DecodeServer`` against each
    prompt's own ``generate``; 16 bf16 teacher-forced
    ``paged_decode_step``s beside ``decode_step``, tokens equal at every
    step."""
    import dataclasses

    import numpy as np
    import torch
    from rlo_tpu_torch.models import generate as G
    from rlo_tpu_torch.models import moe as M
    from rlo_tpu_torch.models import serve as S
    from rlo_tpu_torch.models import transformer as tt
    from rlo_tpu_torch.utils.metrics import Registry

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the f32 router product would round its inputs")
    cfg = tt.TransformerConfig(**SERVE_CFG, n_experts=MOE_EXPERTS)
    params = tt.init_params(cfg, seed=SEED + 15, device=dev)
    n_params = sum(t.numel() for t in tt.tree_leaves(params))
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    out = {}

    loss_k, grads_k = tt.grads_and_loss(params, tokens, cfg)
    with _attention_backward_xla():
        loss_x, grads_x = tt.grads_and_loss(params, tokens, cfg)
    check(bool(torch.isfinite(loss_k)) and torch.equal(loss_k, loss_x),
          f"MoE: the kernel path's loss {float(loss_k)} != the xla mode's "
          f"{float(loss_x)}")
    check(all(torch.isfinite(g).all() for g in tt.tree_leaves(grads_k)),
          "MoE: non-finite grads on the kernel path")
    rel = _rel_l2(grads_k, grads_x)
    check(max(rel) <= GRAD_REL_LIMIT,
          f"MoE: kernel-path grads differ from the xla mode's: max relative "
          f"L2 {max(rel):.3g} > {GRAD_REL_LIMIT}")
    del grads_k, grads_x
    with torch.no_grad(), _routing_counts(M) as seen:
        _, aux = tt.forward(params, tokens, cfg, with_aux=True)
    kept = sum(float(k) for k, _ in seen)
    routed = sum(n for _, n in seen)
    drop = 1.0 - kept / routed
    check(math.isfinite(float(aux)) and float(aux) > 0,
          f"MoE: aux {float(aux)} not finite and > 0")
    print(f"[moe] {n_params} params ({MOE_EXPERTS} experts a layer), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: loss {float(loss_k):.6f} equal with "
          f"the attention backward in xla mode; grads' relative L2 max "
          f"{max(rel):.3g} (limit {GRAD_REL_LIMIT}); aux {float(aux):.6f} "
          f"(summed over {cfg.n_layers} layers); tokens dropped at capacity "
          f"factor {cfg.capacity_factor}: {100 * drop:.2f}%")

    def sgd_steps(n):
        p, walls, losses = params, [], []
        before = {fn.__name__: fn.launches for fn in flash_fns}
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, loss = tt.train_step(p, tokens, cfg, lr=SGD_LR)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        counts = {fn.__name__: (fn.launches - before[fn.__name__]) / n
                  for fn in flash_fns}
        return statistics.median(walls[1:]), losses, counts

    step_ms, sgd, step_counts = sgd_steps(10)
    check(all(map(math.isfinite, sgd)) and sgd[-1] < sgd[0],
          f"MoE SGD losses not finite and falling: {sgd}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    limits = M.PAD_ROWS, M.PAD_RATIO
    M.PAD_ROWS = M.PAD_RATIO = 0          # the sorted dispatch
    try:
        sorted_ms, sorted_l, _ = sgd_steps(4)
    finally:
        M.PAD_ROWS, M.PAD_RATIO = limits
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3
    print(f"[moe] 10 SGD steps (lr {SGD_LR}): "
          f"{' '.join(f'{x:.4f}' for x in sgd)}")
    print(f"[moe] median SGD step {step_ms:.3f} ms ({tok_s:.0f} tokens/s; "
          f"the padded dispatch, {MOE_EXPERTS} x capacity rows, no host "
          f"read); with the sorted dispatch forced (the kept rows only, "
          f"{cfg.n_layers} host reads a step, shapes moving with the "
          f"routing) {sorted_ms:.3f} ms; peak device memory {peak:.2f} GiB; "
          f"launches per step {json.dumps(step_counts)}")
    out["training"] = dict(n_params=n_params, loss=float(loss_k),
                           grad_rel_l2_max=max(rel), aux=float(aux),
                           dropped_share=drop, sgd_losses=sgd,
                           step_ms_median=step_ms, tokens_per_s=tok_s,
                           sorted_step_ms_median=sorted_ms,
                           sorted_losses=sorted_l, peak_mem_gib=peak,
                           launches_per_step=step_counts)
    del params
    torch.cuda.empty_cache()

    # serving, drop-free everywhere. The oracles run in f32: in bf16 a
    # GEMM of another shape rounds a token's hidden state another way, a
    # router near-tie then sends it to another expert, and its logits
    # move by far more than a logit near-tie
    cfg_s = dataclasses.replace(cfg, capacity_factor=float(MOE_EXPERTS))
    cfg_f = dataclasses.replace(cfg_s, dtype="float32")
    f32 = tt.init_params(cfg_s, seed=SEED + 15, device=dev)
    params = tt.cast_params(f32, cfg_s.act_dtype)
    check(all(layer["moe"]["wr"].dtype == torch.float32
              for layer in params["layers"]),
          "cast_params rounded the router")
    b, plen, max_new = (MOE_SERVE[k] for k in ("batch", "plen", "max_new"))
    prompt = torch.randint(0, cfg.vocab, (b, plen), generator=gen,
                           device=dev, dtype=torch.int32)
    G.generate(params, prompt, cfg_s, max_new=2)      # warm-up
    _, out["generate"] = _timed(
        G, params, prompt, cfg_s, max_new,
        f"MoE ({MOE_EXPERTS} experts) generate batch {b}, plen {plen}, "
        f"{max_new} new, bf16")
    with torch.no_grad():
        toks = G.generate(f32, prompt, cfg_f, max_new=max_new)
        seq = torch.cat([prompt, toks[:, :-1]], dim=1)
        logits = tt.forward(f32, seq, cfg_f)[:, plen - 1:]
        want = torch.argmax(logits, -1).cpu().numpy()
        fgaps = top2_gap(logits.reshape(-1, cfg.vocab), cfg_f) \
            .reshape(b, max_new).float().cpu().numpy()
        del logits
    toks = toks.cpu().numpy()
    compared = [compare_until_near_tie(toks[i], want[i], fgaps[i])
                for i in range(b)]
    full = sum(c[1] for c in compared)
    out["generate"]["f32_forward_compared_to_end"] = full
    print(f"[moe] f32 generate's tokens against the argmax of a "
          f"teacher-forced f32 forward over prompt + output: {full} of {b} "
          f"rows equal to the end, the rest up to a parting at a near-tie")

    rng = np.random.default_rng(SEED + 2)
    reqs = []
    for i in range(16):
        n = int(rng.integers(96, 161)) if i % 8 == 3 else \
            int(rng.integers(32, 65))      # long ones extend past the bucket
        reqs.append((rng.integers(0, cfg.vocab, n), int(rng.integers(16, 65))))
    srv = S.DecodeServer(f32, cfg_f, n_slots=8, max_len=256, round_len=16,
                         prompt_buckets=(64,), metrics=Registry())
    t0 = time.perf_counter()
    for p, m in reqs:
        srv.submit(p, m)
    outs = srv.run()
    wall = time.perf_counter() - t0
    check([len(o) for o in outs] == [m for _, m in reqs],
          "the MoE server returned the wrong number of tokens")
    s_full = 0
    for i, (p, m) in enumerate(reqs):
        ptens = torch.as_tensor(p[None].astype(np.int32), device=dev)
        wtoks, g = greedy_with_gaps(f32, ptens, cfg_f, m)
        check(bool((G.generate(f32, ptens, cfg_f, max_new=m)[0].cpu()
                    .numpy() == wtoks[0]).all()),
              f"MoE: greedy_with_gaps differs from generate on request {i}")
        s_full += compare_until_near_tie(outs[i], wtoks[0], g[0])[1]
    del f32
    ntok = sum(len(o) for o in outs)
    out["server"] = dict(requests=16, tokens=ntok, wall_s=wall,
                         tok_per_s=ntok / wall, rounds=srv.rounds_run,
                         compared_to_end=s_full)
    print(f"[moe] f32 DecodeServer(n_slots=8, max_len=256, round_len=16, "
          f"buckets (64,)): 16 requests (2 extended past the bucket), {ntok} "
          f"tokens in {wall:.2f} s ({ntok / wall:.0f} tok/s); tokens equal "
          f"each prompt's own generate, {s_full} of 16 to the end and the "
          f"rest up to a parting at a near-tie")

    out["paged_teacher_forced"] = tf = paged_beside_dense(
        params, cfg_s, prompt, max_new, gen)
    print(f"[moe] teacher-forced batch {b}, plen {plen}, {max_new} steps over "
          f"{tf['pages']} permuted pages of 128: paged and dense greedy tokens "
          f"equal at every step, max |paged - dense logit| "
          f"{tf['max_abs_logit_diff']}; median step dense "
          f"{tf['dense_ms_per_step']:.3f} ms, paged "
          f"{tf['paged_ms_per_step']:.3f} ms")
    return out


# ---------------------------------------------------------------------------
# Phase 13: tensor-, expert- and sequence-parallel inference
# ---------------------------------------------------------------------------

#: phase 13's shapes: TP decode at the flagship serving shape; a GQA+RoPE
#: decode step and T = 4 block; the TP forward through K1; EP decode at
#: phase 12's MoE widths; one long sequence split over sp
TP_DECODE = dict(tp=4, batch=32, plen=1024, max_new=8)
TP_GQA = dict(tp=2, batch=4, plen=128, block=4)
TP_FORWARD = dict(tp=4, batch=4, seq=1024, algorithm="ring")
EP_DECODE = dict(ep=4, batch=32, plen=1024, max_new=8)
SP_FORWARD = dict(sp=4, seq=4096)
#: a model-parallel run's logits against one rank's, as the relative L2
#: norm of their difference: bf16 (the row-parallel sums round each
#: partial product to bf16, one rank rounds the whole product once) and
#: f32
PAR_REL_BF16 = 3e-2
PAR_REL_F32 = 1e-4


def rel_l2(got, want) -> float:
    """|got - want| / |want| over the whole tensors, in f64."""
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm())


def mesh_shards(dev, name, n, tree, specs):
    """A LocalMesh of ``n`` ranks named ``name`` on the card, and each
    rank's slices of ``tree`` (``parallel.sharding.shard_tree``)."""
    from rlo_tpu_torch.parallel.mesh import LocalMesh
    from rlo_tpu_torch.parallel.sharding import shard_tree
    mesh = LocalMesh((n,), (name,), device=dev)
    return mesh, [shard_tree(tree, specs, mesh.axes(r)) for r in range(n)]


def on_ranks(mesh, fn, *per_rank):
    """``fn(axis, *rank's args)`` on every rank of a 1-D ``mesh``, grad
    off (the port's model-parallel paths are inference only)."""
    import torch
    name = mesh.names[0]

    def body(axes, *args):
        with torch.no_grad():
            return fn(axes[name], *args)
    return mesh.run(body, *per_rank)


def measured(counted, fn):
    """One run of ``fn()`` inside a profiled window, the launch counts of
    ``counted`` set to 0 just before it and read just after: its wall
    time (host clock from the call to a synchronise, inside the window),
    device time (its kernels' times summed), peak device memory and
    launches. Returns (result, figures)."""
    import torch
    runs, walls = [], []

    def run():
        t0 = time.perf_counter()
        runs.append(fn())
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counted:
        f.launches = 0
    ran = profiled(run)
    # a take that recorded no kernel ran fn as well, with the same launches
    launches = {f.__name__: f.launches // len(runs) for f in counted}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dev_ms = sum(us for _, us in ran.values()) / 1e3
    copies = sum(us for k, (_, us) in ran.items()
                 if k.startswith("Memcpy DtoD")) / 1e3
    return runs[-1], dict(wall_ms=walls[-1], device_ms=dev_ms,
                          dtod_copy_ms=copies, peak_gib=peak,
                          launches=launches)


def _figures_line(tag, what, st) -> None:
    print(f"[{tag}] {what}: wall {st['wall_ms']:.1f} ms, device "
          f"{st['device_ms']:.3f} ms (of it device-to-device copies "
          f"{st['dtod_copy_ms']:.3f}), peak device memory "
          f"{st['peak_gib']:.2f} GiB, launches {json.dumps(st['launches'])}")


def _tokens_against(got, want, gaps, what, min_full):
    """Each row of ``got`` against the one-rank ``want`` by the near-tie
    rule; at least ``min_full`` rows must compare to the end."""
    compared = [compare_until_near_tie(got[i], want[i], gaps[i])
                for i in range(len(want))]
    full = sum(done for _, done in compared)
    check(full >= min_full, f"{what}: only {full} of {len(want)} rows "
                            f"compared to the end")
    return full


#: the MoE router's noise between an EP run and the one-rank run: until a
#: row's first routing difference its router log-probabilities must be
#: within ROUTER_TOL of the one-rank run's (bf16 roundings of the hidden
#: state move them by about 1e-3 to 1e-2; a misplaced row moves them by
#: O(1)), and a token may go to another expert only where the one-rank
#: run's top-2 router gap is under ROUTER_NEAR_TIE (a flip needs a gap of
#: at most twice the noise)
ROUTER_TOL = 5e-2
ROUTER_NEAR_TIE = 2 * ROUTER_TOL


class RouterLog:
    """While installed (a context), each ``models.moe.route`` call's gate
    probabilities (T, E) f32, kept by the thread that routed them between
    its ``start()`` and ``take()`` (the tensor itself: no copy, no
    launch)."""

    def __init__(self):
        import threading
        self.local = threading.local()

    def __enter__(self):
        from rlo_tpu_torch.models import moe
        self.route = moe.route

        def route(*args, **kw):
            out = self.route(*args, **kw)
            calls = getattr(self.local, "calls", None)
            if calls is not None:
                calls.append(out[0])
            return out
        moe.route = route
        return self

    def __exit__(self, *exc):
        from rlo_tpu_torch.models import moe
        moe.route = self.route
        return False

    def start(self):
        self.local.calls = []

    def take(self) -> list:
        calls, self.local.calls = self.local.calls, None
        return calls


def routes_against(got, want, gaps, rank_calls, want_calls, n_layers,
                   plen):
    """An EP generate's greedy tokens ``got`` (b, n) against the one-rank
    run's ``want`` (its top-2 logit gaps ``gaps``), row by row, with each
    run's router record (``RouterLog``: ``rank_calls`` a list per rank of
    its calls' gates, rows split evenly; ``want_calls`` the one-rank
    run's; a prefill call per layer, then a decode step's per layer).
    Each row's router log-probabilities are compared call by call, up to
    the call group that made the row's first differing token (group 0
    the prefill), until its first routing difference: they must stay
    within ROUTER_TOL, and every token that changed expert there must sit
    at a one-rank router gap under ROUTER_NEAR_TIE. A row whose tokens
    part before any routing difference must part at a logit near-tie
    (NEAR_TIE). Returns (rows equal to the end, [(row, position, logit
    gap, (layer, token position, router gap) of the first routing
    difference or None)] of the rows that part, the largest router
    difference compared)."""
    import numpy as np
    import torch
    b, n = want.shape
    rows = b // len(rank_calls)
    check(len(want_calls) == n_layers * n and all(
        len(c) == n_layers * n for c in rank_calls),
        f"router records of {len(want_calls)} / "
        f"{[len(c) for c in rank_calls]} calls, not {n_layers} x {n}")
    full, partings, worst = 0, [], 0.0
    for i in range(b):
        r, li = divmod(i, rows)
        bad = np.nonzero(np.asarray(got[i]) != np.asarray(want[i]))[0]
        last = int(bad[0]) if len(bad) else n - 1
        flip = None
        for k in range(n_layers * (last + 1)):
            g = k // n_layers
            span = plen if g == 0 else 1
            lw = want_calls[k][i * span:(i + 1) * span].double().log()
            lg = rank_calls[r][k][li * span:(li + 1) * span].double().log()
            noise = float((lg - lw).abs().max())
            worst = max(worst, noise)
            check(noise <= ROUTER_TOL,
                  f"row {i}: router log-probabilities {noise:.3g} from the "
                  f"one-rank run's at layer {k % n_layers} of call group "
                  f"{g}, before any routing difference (limit {ROUTER_TOL})")
            moved = torch.nonzero(lw.argmax(-1) != lg.argmax(-1))[:, 0]
            if len(moved):
                top2 = lw.topk(2, dim=-1).values
                gap = top2[:, 0] - top2[:, 1]
                t = int(moved[gap[moved].argmax()])
                flip = (k % n_layers, t if g == 0 else plen + g - 1,
                        round(float(gap[t]), 4))
                check(flip[2] < ROUTER_NEAR_TIE,
                      f"row {i}: a token changed expert at layer {flip[0]}, "
                      f"position {flip[1]}, where the one-rank router gap "
                      f"is {flip[2]} (not under {ROUTER_NEAR_TIE})")
                break
        if not len(bad):
            full += 1
            continue
        p = int(bad[0])
        if flip is None:
            check(gaps[i][p] < NEAR_TIE,
                  f"row {i}: tokens part at position {p} where the "
                  f"reference's top-2 gap is {gaps[i][p]:.4g}, with no "
                  f"routing difference before it")
        partings.append((i, p, round(float(gaps[i][p]), 4), flip))
    return full, partings, worst


def phase_parallel(dev, counted) -> dict:
    """Tensor-, expert- and sequence-parallel inference at full width,
    each rank a thread of a ``LocalMesh`` on the one card (13a-13d).
    Each path runs once, inside a profiled window, with the launch counts
    of ``counted`` set to 0 just before and read just after
    (``measured``)."""
    import dataclasses

    import numpy as np
    import torch
    from rlo_tpu_torch.models import generate as G
    from rlo_tpu_torch.models import transformer as tt
    from rlo_tpu_torch.ops.ring_attention import (stripe_sequence,
                                                  unstripe_sequence)

    out, paths = {}, {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)

    # 13a: TP decode at the flagship serving shape, tp = 4
    cfg = tt.TransformerConfig(**SERVE_CFG)
    params = tt.init_params(cfg, seed=SEED + 21, device=dev)
    b, plen, max_new = (TP_DECODE[k] for k in ("batch", "plen", "max_new"))
    prompt = torch.randint(0, cfg.vocab, (b, plen), generator=gen,
                           device=dev, dtype=torch.int32)
    want, gaps = greedy_with_gaps(params, prompt, cfg, max_new)
    mesh, shards = mesh_shards(dev, "tp", TP_DECODE["tp"], params,
                               tt.param_pspecs(cfg, "tp"))
    del params
    run = lambda: on_ranks(mesh, lambda ax, p: G.generate(  # noqa: E731
        p, prompt, cfg, max_new=max_new, tp_axis=ax), shards)
    toks, st = measured(counted, run)
    check(all(torch.equal(t, toks[0]) for t in toks),
          "TP generate: the ranks' tokens differ")
    full = _tokens_against(toks[0].cpu().numpy(), want, gaps,
                           "TP generate", b * 3 // 4)
    _figures_line("tp", f"generate tp={TP_DECODE['tp']}, batch {b}, plen "
                        f"{plen}, {max_new} new, bf16", st)
    print(f"[tp] tokens equal the one-rank generate's on {full} of {b} rows "
          f"to the end, the rest up to a parting at a near-tie; every rank "
          f"the same tokens")
    out["tp_generate"] = dict(st, rows_compared_to_end=full)
    paths["tp_generate"] = st["launches"]
    del shards, mesh, toks

    # GQA+RoPE decode_step and T = 4 block_decode, bf16 and int8 caches
    gq, res = TP_GQA, {}
    for kv in (None, "int8"):
        gcfg = tt.TransformerConfig(**GQA_CFG, kv_cache_dtype=kv)
        gp = tt.cast_params(tt.init_params(gcfg, seed=SEED + 22, device=dev),
                            gcfg.act_dtype)
        gprompt = torch.randint(0, gcfg.vocab, (gq["batch"], gq["plen"]),
                                generator=gen, device=dev, dtype=torch.int32)
        tok = torch.randint(0, gcfg.vocab, (gq["batch"],), generator=gen,
                            device=dev, dtype=torch.int32)
        blk = torch.randint(0, gcfg.vocab, (gq["batch"], gq["block"]),
                            generator=gen, device=dev, dtype=torch.int32)

        def chain(p, ax=None):
            c = G.init_kv_cache(gcfg, gq["batch"],
                                gq["plen"] + 1 + gq["block"], device=dev,
                                tp_axis=ax)
            _, c = G.prefill(p, gprompt, c, gcfg, tp_axis=ax)
            l1, c = G.decode_step(p, tok, gq["plen"], c, gcfg, tp_axis=ax)
            l2, _ = G.block_decode(p, blk, gq["plen"] + 1, c, gcfg,
                                   tp_axis=ax)
            return l1, l2

        with torch.no_grad():
            w1, w2 = chain(gp)
        gmesh, gshards = mesh_shards(dev, "tp", gq["tp"], gp,
                                     tt.param_pspecs(gcfg, "tp"))
        got, gst = measured(counted, lambda: on_ranks(
            gmesh, lambda ax, p: chain(p, ax), gshards))
        check(all(torch.equal(x, y) for r in got[1:]
                  for x, y in zip(r, got[0])),
              "TP decode: the ranks' logits differ")
        e1, e2 = rel_l2(got[0][0], w1), rel_l2(got[0][1], w2)
        agree = float((got[0][1].argmax(-1) == w2.argmax(-1)).float().mean())
        check(max(e1, e2) <= PAR_REL_BF16,
              f"TP GQA decode ({kv or 'bf16'} cache): logits' relative L2 "
              f"{e1:.3g} / {e2:.3g} > {PAR_REL_BF16}")
        name = kv or "bf16"
        _figures_line("tp", f"GQA+RoPE tp={gq['tp']} prefill + decode_step + "
                            f"block_decode (T={gq['block']}), {name} cache",
                      gst)
        print(f"[tp] GQA {name} cache: logits against one rank's, relative "
              f"L2 decode_step {e1:.3g}, block_decode {e2:.3g} (limit "
              f"{PAR_REL_BF16}); block argmax equal at {100 * agree:.1f}%; "
              f"every rank the same bits")
        res[name] = dict(gst, rel_l2_step=e1, rel_l2_block=e2,
                         block_argmax_agree=agree)
        paths[f"tp_gqa_{name}"] = gst["launches"]
        del gmesh, gshards, gp
    out["tp_gqa"] = res

    # 13b: the TP forward through K1 (ring allreduce), tp = 4
    cfg = tt.TransformerConfig(**SERVE_CFG)
    params = tt.cast_params(tt.init_params(cfg, seed=SEED + 23, device=dev),
                            cfg.act_dtype)
    tokens = torch.randint(0, cfg.vocab, (TP_FORWARD["batch"],
                                          TP_FORWARD["seq"]),
                           generator=gen, device=dev, dtype=torch.int32)
    with torch.no_grad():
        want_l = tt.forward(params, tokens, cfg)
    mesh, shards = mesh_shards(dev, "tp", TP_FORWARD["tp"], params,
                               tt.param_pspecs(cfg, "tp"))
    del params
    logits, st = measured(counted, lambda: on_ranks(
        mesh, lambda ax, p: tt.forward(
            p, tokens, cfg, tp_axis=ax,
            tp_algorithm=TP_FORWARD["algorithm"]), shards))
    check(all(torch.equal(lg, logits[0]) for lg in logits[1:]),
          "TP forward: the ranks' logits differ")
    e = rel_l2(logits[0], want_l)
    mx = float((logits[0] - want_l).abs().max())
    agree = float((logits[0].argmax(-1) == want_l.argmax(-1)).float().mean())
    check(e <= PAR_REL_BF16, f"TP forward: logits' relative L2 {e:.3g} > "
                             f"{PAR_REL_BF16}")
    check(st["launches"].get("fused_combine", 0) > 0,
          "TP forward: K1 was not launched")
    _figures_line("tp", f"forward tp={TP_FORWARD['tp']} "
                        f"({TP_FORWARD['algorithm']} allreduce), "
                        f"{TP_FORWARD['batch']} x {TP_FORWARD['seq']}, bf16",
                  st)
    print(f"[tp] forward logits against one rank's: relative L2 {e:.3g} "
          f"(limit {PAR_REL_BF16}), max |diff| {mx:.4g}, argmax equal at "
          f"{100 * agree:.2f}%; every rank the same bits")
    out["tp_forward"] = dict(st, rel_l2=e, max_abs=mx, argmax_agree=agree)
    paths["tp_forward"] = st["launches"]
    del mesh, shards, logits, want_l

    # 13c: EP decode at phase 12's MoE widths, ep = 4, rows split
    b, plen, max_new = (EP_DECODE[k] for k in ("batch", "plen", "max_new"))
    mcfg = tt.TransformerConfig(**SERVE_CFG, n_experts=MOE_EXPERTS,
                                capacity_factor=float(MOE_EXPERTS))
    f32 = tt.init_params(mcfg, seed=SEED + 24, device=dev)
    prompt = torch.randint(0, mcfg.vocab, (b, plen), generator=gen,
                           device=dev, dtype=torch.int32)
    rows = list(prompt.chunk(EP_DECODE["ep"]))
    res = {}
    log = RouterLog()

    def ep_generate(ax, p, t, c, alg):
        log.start()
        toks = G.generate(p, t, c, max_new=max_new, ep_axis=ax,
                          all_to_all_algorithm=alg)
        return toks, log.take()

    for dtype in ("float32", "bfloat16"):
        c0 = dataclasses.replace(mcfg, dtype=dtype)
        params = tt.cast_params(f32, c0.act_dtype)
        with log:
            log.start()
            want, gaps = greedy_with_gaps(params, prompt, c0, max_new)
            want_calls = log.take()
        mesh, shards = mesh_shards(dev, "ep", EP_DECODE["ep"], params,
                                   tt.param_pspecs(c0, ep_axis="ep"))
        del params
        by_alg, routed = {}, {}
        for alg in ("xla", "direct"):
            with log:
                ran, st = measured(counted, lambda: on_ranks(
                    mesh, lambda ax, p, t: ep_generate(ax, p, t, c0, alg),
                    shards, rows))
            by_alg[alg] = torch.cat([t for t, _ in ran])
            routed[alg] = [r for _, r in ran]
            what = f"generate ep={EP_DECODE['ep']} ({alg} all_to_all), " \
                   f"{MOE_EXPERTS} experts, batch {b} ({b // EP_DECODE['ep']}" \
                   f" a rank), plen {plen}, {max_new} new, {dtype}"
            _figures_line("ep", what, st)
            res[f"{dtype}_{alg}"] = st
            paths[f"ep_generate_{dtype}_{alg}"] = st["launches"]
        # the schedules move the same bytes: the same tokens, bit for bit
        check(torch.equal(by_alg["xla"], by_alg["direct"]),
              f"EP generate {dtype}: 'xla' and 'direct' tokens differ")
        full, partings, noise = routes_against(
            by_alg["xla"].cpu().numpy(), want, gaps, routed["xla"],
            want_calls, c0.n_layers, plen)
        del routed, want_calls
        need = b if dtype == "float32" else b // 2
        check(full >= need, f"EP generate {dtype}: only {full} of {b} rows "
                            f"equal the one-rank generate's to the end")
        print(f"[ep] {dtype}: tokens equal the one-rank generate's on {full} "
              f"of {b} rows to the end (both all_to_alls the same bits); "
              f"router log-probabilities within {noise:.3g} of the one-rank "
              f"run's up to each row's first routing difference (limit "
              f"{ROUTER_TOL}); partings (row, position, scaled top-2 logit "
              f"gap, first routing difference as (layer, token position, "
              f"one-rank router gap) or None) {partings}")
        for alg in by_alg:
            res[f"{dtype}_{alg}"].update(rows_equal_to_end=full,
                                         router_noise=noise,
                                         partings=partings)
        del mesh, shards
    del f32
    out["ep_generate"] = res

    # 13d: SP forward, one sequence split over sp = 4
    sp, seq = SP_FORWARD["sp"], SP_FORWARD["seq"]
    base = tt.TransformerConfig(**SERVE_CFG)
    f32 = tt.init_params(base, seed=SEED + 25, device=dev)
    tokens = torch.randint(0, base.vocab, (1, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    res = {}
    for dtype in ("bfloat16", "float32"):
        c0 = dataclasses.replace(base, dtype=dtype)
        params = tt.cast_params(f32, c0.act_dtype)
        with torch.no_grad():
            want_l = tt.forward(params, tokens, c0)[0]
        mesh, shards = mesh_shards(dev, "sp", sp, params,
                                   tt.param_pspecs(c0))
        del params
        limit = PAR_REL_BF16 if dtype == "bfloat16" else PAR_REL_F32
        for att, layout in (("ring", "contiguous"), ("ring", "striped"),
                            ("ulysses", "contiguous")):
            c = dataclasses.replace(c0, sp_attention=att, sp_layout=layout)
            s = tokens[0]
            if layout == "striped":
                s = stripe_sequence(s, sp)
            blocks = [t[None].contiguous() for t in s.chunk(sp)]
            logits, st = measured(counted, lambda: on_ranks(
                mesh, lambda ax, p, t: tt.forward(p, t, c, sp_axis=ax)[0],
                shards, blocks))
            got = torch.cat(logits)
            if layout == "striped":
                got = unstripe_sequence(got, sp)
            e = rel_l2(got, want_l)
            mx = float((got - want_l).abs().max())
            check(e <= limit, f"SP forward {att} {layout} {dtype}: logits' "
                              f"relative L2 {e:.3g} > {limit}")
            steps = sp if att == "ring" else 1
            k2 = st["launches"].get("flash_block_update_hld", 0)
            check(k2 == steps * c.n_layers * sp,
                  f"SP forward {att}: K2 launched {k2} times, not "
                  f"{steps} x {c.n_layers} layers x {sp} ranks")
            _figures_line("sp", f"forward sp={sp} {att} {layout}, 1 x {seq} "
                                f"({seq // sp} a rank), {dtype}", st)
            kv_mib = 2 * c.kv_heads * (seq // sp) * c.head_dim * \
                torch.finfo(c.act_dtype).bits / 8 / 2 ** 20
            extra = (f"; a ring step clones {kv_mib:.2f} MiB of K/V a rank "
                     f"(the LocalMesh exchange), {sp - 1} steps of {sp} a "
                     f"layer" if att == "ring" else "")
            print(f"[sp] logits against one rank's forward: relative L2 "
                  f"{e:.3g} (limit {limit}), max |diff| {mx:.4g}; K2 "
                  f"{k2} launches{extra}")
            res[f"{att}_{layout}_{dtype}"] = dict(st, rel_l2=e, max_abs=mx)
            if dtype == "bfloat16":
                paths[f"sp_{att}_{layout}"] = st["launches"]
        del mesh, shards, want_l
    del f32
    out["sp_forward"] = res
    out["launches_by_path"] = paths
    return out


# ---------------------------------------------------------------------------
# Phase 14: pipeline-parallel training at full width
# ---------------------------------------------------------------------------

#: phase 14: one batch of batch x seq at the flagship's widths; (a)-(c)
#: at pp 4 (2 layers a stage) in n_micro microbatches; (d) at (dp, pp)
#: in dp_micro; (e) resume_steps 1F1B steps at pp resume_pp; each
#: schedule's step timed reps times
PIPE = dict(batch=8, seq=1024, pp=4, n_micro=8, dp=2, dp_pp=2, dp_micro=4,
            resume_pp=2, resume_steps=3, reps=3)
#: the pipelined loss against the single-card step's, relative
PIPE_LOSS_RTOL = 1e-3


class CountingAxis:
    """An ``Axis`` that counts its ``ppermute`` calls and hands every
    call on to the axis it wraps."""

    def __init__(self, axis):
        self.axis, self.size, self.index = axis, axis.size, axis.index
        self.device, self.leader = axis.device, axis.leader
        self.permutes = 0

    def ppermute(self, x, pairs):
        self.permutes += 1
        return self.axis.ppermute(x, pairs)

    def all_reduce(self, x, op):
        return self.axis.all_reduce(x, op)


def pipe_mesh(dev, cfg, stacked, dp, pp):
    """A (dp, pp) ``LocalMesh`` on the card (1-D when dp is None) and
    each rank's slices of the stacked params."""
    from rlo_tpu_torch.models.pipeline import pipeline_pspecs
    from rlo_tpu_torch.parallel.mesh import LocalMesh
    from rlo_tpu_torch.parallel.sharding import shard_tree
    mesh = LocalMesh((pp,) if dp is None else (dp, pp),
                     ("pp",) if dp is None else ("dp", "pp"), device=dev)
    specs = pipeline_pspecs("pp", cfg)
    return mesh, specs, [shard_tree(stacked, specs, mesh.axes(r))
                         for r in range(mesh.world_size)]


def pipe_steps(mesh, cfg, fn, shards, batches, n_micro):
    """``fn`` (a pipelined step) over ``batches`` in turn on every rank
    of ``mesh``, each dp rank on its rows. Returns, per rank, (stage
    params, the losses, its ppermute calls, the last step's stats)."""
    def body(axes, p):
        pp_axis = CountingAxis(axes["pp"])
        dp_axis = axes.get("dp")
        losses, st = [], {}
        for tok in batches:
            if dp_axis is not None:
                rows = tok.shape[0] // dp_axis.size
                tok = tok[dp_axis.index * rows:(dp_axis.index + 1) * rows]
            p, loss = fn(p, tok, cfg, pp_axis, n_micro, lr=SGD_LR,
                         dp_axis=dp_axis, stats=st)
            losses.append(loss)
        return p, losses, pp_axis.permutes, st
    return mesh.run(body, shards)


def _same_on_ranks(values, what) -> None:
    import torch
    check(all(torch.equal(v, values[0]) for v in values),
          f"{what}: the ranks hold different values")


def _pipe_update(mesh, specs, outs, cfg, params):
    """The gathered, unstacked new params' update (new - old) per leaf."""
    from rlo_tpu_torch.models import transformer as tt
    from rlo_tpu_torch.models.pipeline import unstack_layers
    from rlo_tpu_torch.parallel.sharding import gather_tree
    new = unstack_layers(gather_tree([o[0] for o in outs], specs, mesh),
                         cfg.n_layers)
    return [n - o for n, o in zip(tt.tree_leaves(new),
                                  tt.tree_leaves(params))]


def _against(tag, loss, update, want_loss, want_update, what) -> dict:
    """Loss within PIPE_LOSS_RTOL and each tensor of the update within
    DP_REL_LIMIT (relative L2) of ``want``'s."""
    lrel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    rel = [rel_l2(g, w) for g, w in zip(update, want_update)]
    check(math.isfinite(float(loss)) and lrel <= PIPE_LOSS_RTOL,
          f"{tag}: loss {float(loss)} against {what}'s {float(want_loss)} "
          f"(relative {lrel:.3g} > {PIPE_LOSS_RTOL})")
    check(max(rel) <= DP_REL_LIMIT,
          f"{tag}: update differs from {what}'s: max relative L2 "
          f"{max(rel):.3g} > {DP_REL_LIMIT}")
    print(f"[pipeline] {tag} against {what}: loss {float(loss):.6f} vs "
          f"{float(want_loss):.6f} (relative {lrel:.3g}); update relative "
          f"L2 per tensor max {max(rel):.3g}, median "
          f"{statistics.median(rel):.3g} (limit {DP_REL_LIMIT})")
    return {"loss": float(loss), "loss_rel": lrel, "update_rel_l2_max":
            max(rel), "update_rel_l2_median": statistics.median(rel)}


def phase_pipeline(dev, counted) -> dict:
    """Pipeline-parallel training at the flagship's widths (14a-14g):
    the stages are threads of a ``LocalMesh`` on the one card, cut by
    ``pipeline_pspecs``/``shard_tree``. ``counted`` are K2, K4 and K5's
    wrappers; their launches are read around each pipelined step."""
    import tempfile

    import torch
    from rlo_tpu_torch.models import pipeline as pl
    from rlo_tpu_torch.models import transformer as tt
    from rlo_tpu_torch.parallel.sharding import gather_tree
    from rlo_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = tt.TransformerConfig(**SERVE_CFG)
    params = tt.init_params(cfg, seed=SEED, device=dev)
    stacked = pl.stack_layers(params)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    batches = [torch.randint(0, cfg.vocab, (PIPE["batch"], PIPE["seq"]),
                             generator=gen, device=dev, dtype=torch.int32)
               for _ in range(PIPE["resume_steps"])]
    tokens = batches[0]
    out, walls = {}, {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def resident():
        """GiB allocated now; the peak counter starts again from here."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated() / 2 ** 30

    # the single-card step on the same batch (phase 9's path)
    single_base = resident()
    runs = [timed(lambda: tt.train_step(params, tokens, cfg, lr=SGD_LR))
            for _ in range(PIPE["reps"])]
    single_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    (single_new, single_loss), _ = runs[0]
    walls["single"] = [ms for _, ms in runs]
    want = [n - o for n, o in zip(tt.tree_leaves(single_new),
                                  tt.tree_leaves(params))]
    del single_new, runs

    # (a)-(c), (f), (g): GPipe and 1F1B at pp 4
    pp, M = PIPE["pp"], PIPE["n_micro"]
    mesh, specs, shards = pipe_mesh(dev, cfg, stacked, None, pp)
    updates, per_step = {}, {}
    for name, fn in (("gpipe", pl.pipeline_train_step),
                     ("1f1b", pl.pipeline_1f1b_train_step)):
        cost = pl.pipeline_cost(name, pp, M)
        base = resident()
        before = {f.__name__: f.launches for f in counted}
        outs, ms = timed(lambda: pipe_steps(mesh, cfg, fn, shards, [tokens],
                                            M))
        per_step[name] = {f.__name__: f.launches - before[f.__name__]
                          for f in counted}
        runs = [ms] + [timed(lambda: pipe_steps(mesh, cfg, fn, shards,
                                                [tokens], M))[1]
                       for _ in range(PIPE["reps"] - 1)]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        walls[name] = runs
        _same_on_ranks([o[1][0] for o in outs], f"{name} loss")
        permutes = [o[2] for o in outs]
        st = outs[0][3]
        want_permutes = cost["total_ticks"] * cost["permutes_per_tick"]
        check(permutes == [want_permutes] * pp and
              st["ticks"] == cost["total_ticks"],
              f"{name}: ppermute calls per rank {permutes}, ticks "
              f"{st['ticks']}; pipeline_cost gives {want_permutes} in "
              f"{cost['total_ticks']} ticks")
        if name == "1f1b":
            check(st["ring_slots"] == st["ring_written"]
                  == cost["peak_boundary_blocks"],
                  f"1F1B ring of {st['ring_slots']} slots "
                  f"({st['ring_written']} written); pipeline_cost's "
                  f"peak_boundary_blocks is "
                  f"{cost['peak_boundary_blocks']}")
        updates[name] = _pipe_update(mesh, specs, outs, cfg, params)
        out[name] = _against(f"14{'a' if name == 'gpipe' else 'b'} {name} "
                             f"(pp {pp}, {M} microbatches)",
                             outs[0][1][0], updates[name], single_loss, want,
                             "the single-card step")
        out[name].update(
            permutes_per_rank=permutes[0], ticks=st["ticks"],
            peak_stage_graphs=st["peak_live_graphs"],
            ring_slots=st.get("ring_slots"), peak_gib=peak,
            resident_gib=base,
            launches_per_step=per_step[name],
            cost={k: cost[k] for k in ("total_ticks", "permutes_per_tick",
                                       "peak_boundary_blocks")})
        del outs
        print(f"[pipeline] 14c {name}: {permutes[0]} ppermute calls a rank "
              f"= {cost['total_ticks']} ticks x {cost['permutes_per_tick']} "
              f"(pipeline_cost); "
              + (f"ring of {st['ring_slots']} saved stage inputs "
                 f"(peak_boundary_blocks {cost['peak_boundary_blocks']})"
                 if name == "1f1b" else
                 f"at most {st['peak_live_graphs']} stage graphs held a "
                 f"stage (the JAX package's carry history: "
                 f"{cost['peak_boundary_blocks']} blocks)")
              + f"; peak device memory {peak:.2f} GiB, {base:.2f} of it "
              f"held by the phase before the steps (single card "
              f"{single_peak:.2f} and {single_base:.2f}); K2/K4/K5 launches "
              f"per step "
              f"{json.dumps(per_step[name])}")
    out["1f1b_vs_gpipe"] = _against("14b 1f1b", out["1f1b"]["loss"],
                                    updates["1f1b"], out["gpipe"]["loss"],
                                    updates["gpipe"], "GPipe")
    del updates, shards, mesh

    # (d) dp x pp
    for name, fn in (("gpipe", pl.pipeline_train_step),
                     ("1f1b", pl.pipeline_1f1b_train_step)):
        mesh, specs, shards = pipe_mesh(dev, cfg, stacked, PIPE["dp"],
                                        PIPE["dp_pp"])
        outs = pipe_steps(mesh, cfg, fn, shards, [tokens], PIPE["dp_micro"])
        _same_on_ranks([o[1][0] for o in outs], f"dp x pp {name} loss")
        out[f"dp_{name}"] = _against(
            f"14d {name} (dp {PIPE['dp']} x pp {PIPE['dp_pp']}, "
            f"{PIPE['dp_micro']} microbatches)", outs[0][1][0],
            _pipe_update(mesh, specs, outs, cfg, params), single_loss, want,
            "the single-card step")
        del outs, shards, mesh

    # (e) resume: 1F1B steps at pp 2, straight and through a checkpoint
    rp, steps = PIPE["resume_pp"], PIPE["resume_steps"]
    fn = pl.pipeline_1f1b_train_step
    mesh, specs, shards = pipe_mesh(dev, cfg, stacked, None, rp)
    straight = pipe_steps(mesh, cfg, fn, shards, batches, M)
    first = pipe_steps(mesh, cfg, fn, shards, batches[:1], M)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        mgr.save(1, {"params": gather_tree([o[0] for o in first], specs,
                                           mesh), "step": 1})
        like = {"params": _tree_map(torch.zeros_like, stacked), "step": 0}
        restored = mgr.restore(like=like)
    check(int(restored["step"]) == 1, "the checkpoint's step")
    mesh2, specs2, shards2 = pipe_mesh(dev, cfg, restored["params"], None,
                                       rp)
    resumed = pipe_steps(mesh2, cfg, fn, shards2, batches[1:], M)
    got_l = [float(x) for x in first[0][1] + resumed[0][1]]
    want_l = [float(x) for x in straight[0][1]]
    same = all(torch.equal(a, b) for a, b in zip(
        tt.tree_leaves(gather_tree([o[0] for o in resumed], specs2, mesh2)),
        tt.tree_leaves(gather_tree([o[0] for o in straight], specs, mesh))))
    check(got_l == want_l and same,
          f"14e: the resumed run parted from the uninterrupted one: losses "
          f"{got_l} vs {want_l}, params equal: {same}")
    print(f"[pipeline] 14e resume: {steps} 1F1B steps at pp {rp} straight "
          f"and through a CheckpointManager save after step 1, restored "
          f"onto the card into a fresh pp {rp} layout: losses "
          f"{' '.join(f'{x:.6f}' for x in want_l)} and params bit-identical")
    out["resume"] = {"losses": want_l, "bit_identical": True}
    del straight, first, resumed, shards, shards2, restored

    # (g) wall time per step
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(f"[pipeline] 14g median wall per step (of {PIPE['reps']}; stages "
          f"as LocalMesh threads on one card, not a figure for pipelining "
          f"across cards): single card {med['single']:.1f} ms, GPipe "
          f"{med['gpipe']:.1f} ms, 1F1B {med['1f1b']:.1f} ms")
    out["wall_ms_median"] = med
    out["single_peak_gib"] = single_peak
    out["single_resident_gib"] = single_base
    return out


# ---------------------------------------------------------------------------
# Phase 15: the consensus-gated bridge, several processes on the card, and
# engine tracing
# ---------------------------------------------------------------------------

#: the rootless proposer of the bridge's rounds (not rank 0)
BRIDGE_PROPOSER = 5
#: K1's kernels (csrc/reduce.cu: combine_vec_kernel, combine_scalar_kernel)
K1_KERNEL_KEY = "combine_"
#: the multi-process phase: processes on the one card, and each
#: process's own time limit (the parent fails the phase past it)
MULTIHOST = dict(procs=4, timeout_s=240.0)
#: the annotation around the gated rounds
BRIDGE_RANGE = "rlo-bridge-gated-rounds"


def _window(on_card: bool, fn):
    """One ``rlo_tpu_torch.utils.tracing.profile`` window (CPU and CUDA
    activities, a Chrome trace into a scratch directory) around ``fn()``:
    on the card it opens with ``WINDOW_OPENERS`` spin kernels and a
    synchronise, and idles inside both edges. Returns (profiler, what
    ``fn`` returned, openers recorded)."""
    import tempfile
    import torch
    from rlo_tpu_torch.utils.tracing import profile
    with tempfile.TemporaryDirectory() as logdir:
        if on_card:
            torch.cuda.synchronize()
        with profile(logdir) as prof:
            if on_card:
                for _ in range(WINDOW_OPENERS):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
            time.sleep(WINDOW_IDLE_S)
            out = fn()
            if on_card:
                torch.cuda.synchronize()
            time.sleep(WINDOW_IDLE_S)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    opened = sum(WINDOW_OPENER in e.name for e in kernels)
    return prof, out, opened


def _device_kernels(prof):
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and WINDOW_OPENER not in e.name]


def phase_bridge(dev, n: int) -> dict:
    """(a) the hybrid facade's gated collectives at ``n`` fp32 a rank
    against the ungated ``TorchBackend`` calls, the vetoes, the times (the
    gate's judged round on the C engines and, beside it, on the Python
    engines); (c) the gated rounds inside an annotation, and one round's
    C-engine events (the C core's trace ring) on the device against the
    CPU's."""
    import torch
    import rlo_tpu_torch
    from rlo_tpu_torch.bridge import HybridBackend, run_judged_proposal
    from rlo_tpu_torch.kernels import reduce as k1
    from rlo_tpu_torch.native import bindings as native
    from rlo_tpu_torch.utils.tracing import annotate

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    h = rlo_tpu_torch.init(backend="hybrid", world_size=WS,
                           device=None if on_card else dev)
    b = rlo_tpu_torch.init(backend="cuda", world_size=WS,
                           device=None if on_card else dev)
    p = BRIDGE_PROPOSER
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    xs = [torch.randn(n, generator=gen, device=dev) for _ in range(WS)]
    finite = lambda v: torch.isfinite(v).all().to(torch.int32)  # noqa: E731
    stats = {"k1_gated_launches": 0}

    def gated_call(fn):
        """``fn()`` with K1's launches in it added to the gated path's
        count (the ungated calls it is held against do not count)."""
        before = k1.fused_combine.launches
        out = fn()
        stats["k1_gated_launches"] += k1.fused_combine.launches - before
        return out

    # (a)+(c): the approved gated rounds, inside one annotation in one
    # profiled window, then held bit for bit against the ungated calls
    before = k1.fused_combine.launches

    def gated():
        with annotate(BRIDGE_RANGE):
            out = {"allreduce": h.propose_collective(
                       "allreduce", xs, proposer=p, algorithm="ring"),
                   "reduce_scatter": h.propose_collective(
                       "reduce_scatter", xs, proposer=p),
                   "all_gather": h.propose_collective(
                       "all_gather", xs, proposer=p)}
            sync()
        return out
    prof, got, opened = gated_call(lambda: _window(on_card, gated))
    gated_launches = k1.fused_combine.launches - before
    check(gated_launches > 0, "K1 was not launched by the gated rounds")
    for op, (d, _) in got.items():
        check(d == 1, f"gated {op} from proposer {p} was not approved")
    ungated = {"allreduce": lambda: b.allreduce(xs, algorithm="ring"),
               "reduce_scatter": lambda: b.reduce_scatter(xs),
               "all_gather": lambda: b.all_gather(xs)}
    for op, call in ungated.items():
        want = call()
        sync()
        check(all(same_bits(g, w) for g, w in zip(got[op][1], want)),
              f"gated {op} differs from the ungated TorchBackend call")
        del want
    del got
    ann = [e for e in prof.events() if e.name == BRIDGE_RANGE]
    check(len(ann) == 1, f"the profiler recorded {len(ann)} "
          f"'{BRIDGE_RANGE}' ranges, not 1")
    k1_evts = [e for e in _device_kernels(prof) if K1_KERNEL_KEY in e.name]
    a0, a1 = ann[0].time_range.start, ann[0].time_range.end
    if on_card:
        check(len(k1_evts) > 0, "the profiled window recorded no K1 kernel")
        inside = [e for e in k1_evts
                  if a0 <= e.time_range.start and e.time_range.end <= a1]
        check(len(inside) == len(k1_evts),
              f"{len(k1_evts) - len(inside)} of {len(k1_evts)} K1 kernels "
              f"lie outside the annotation's range")
        stats["annotation"] = dict(
            range_ms=(a1 - a0) / 1e3, k1_kernels_in_range=len(inside),
            k1_launches_counted=gated_launches, openers_recorded=opened,
            first_k1_after_start_us=min(e.time_range.start
                                        for e in k1_evts) - a0,
            last_k1_before_end_us=a1 - max(e.time_range.end
                                           for e in k1_evts))
        print(f"[bridge] annotation '{BRIDGE_RANGE}' {(a1 - a0) / 1e3:.3f} "
              f"ms holds all {len(inside)} K1 kernels the profiler "
              f"recorded ({gated_launches} launches counted; "
              f"{opened}/{WINDOW_OPENERS} openers recorded)")
    print(f"[bridge] gated allreduce (ring), reduce_scatter and all_gather "
          f"from proposer {p}, {n * 4 // 2 ** 20} MiB fp32 a rank x {WS} "
          f"ranks: approved, bit-identical to the ungated TorchBackend "
          f"calls")

    # (a) vetoes: shape and dtype before any device work
    bad_shape = list(xs)
    bad_shape[3] = xs[3][: n // 2]
    bad_dtype = list(xs)
    bad_dtype[1] = xs[1].to(torch.bfloat16)
    sync()
    for what, ys in (("shape", bad_shape), ("dtype", bad_dtype)):
        before = k1.fused_combine.launches
        prof, (d, out), opened = _window(on_card, lambda ys=ys: (
            h.propose_collective("allreduce", ys, proposer=p,
                                 algorithm="ring")))
        ran = _device_kernels(prof)
        check(d == 0 and out is None, f"the {what} mismatch was not vetoed")
        check(k1.fused_combine.launches == before,
              f"K1 launched in the {what}-vetoed round")
        check(not ran, f"the {what}-vetoed round ran device work: "
              f"{sorted({e.name for e in ran})}")
        if on_card:
            check(opened > 0, "the veto window recorded no opener: the "
                  "profiler was not recording")
        stats[f"{what}_veto"] = dict(decision=d, kernels=len(ran),
                                     openers_recorded=opened)
        print(f"[bridge] {what} mismatch on one rank: decision 0, no K1 "
              f"and no kernel at all in its profiled window ({opened}/"
              f"{WINDOW_OPENERS} openers recorded)")
    del bad_shape, bad_dtype

    # (a) device-judge votes, each rank's from its own tensor on the card
    d, out = gated_call(lambda: h.propose_collective(
        "allreduce", xs, proposer=p, device_judge=finite, algorithm="ring"))
    check(d == 1, "a clean device-judged round was vetoed")
    del out
    for who, rank in (("non-proposer rank 6", 6), ("the proposer", p)):
        ys = list(xs)
        ys[rank] = xs[rank].clone()
        ys[rank][n // 3] = float("nan")
        before = k1.fused_combine.launches
        d, out = h.propose_collective("allreduce", ys, proposer=p,
                                      device_judge=finite, algorithm="ring")
        check(d == 0 and out is None,
              f"a NaN in {who}'s device tensor was not vetoed")
        check(k1.fused_combine.launches == before,
              f"K1 launched in the round {who} vetoed")
        del ys
    print(f"[bridge] device_judge: clean -> 1; a NaN in rank 6's tensor "
          f"-> 0; a NaN in proposer {p}'s own tensor -> 0 (no K1)")

    # (a) times: gated and ungated allreduce, one consensus round
    stats["gated_allreduce_ms"] = gated_call(lambda: wall_ms(
        lambda: h.propose_collective("allreduce", xs, proposer=p,
                                     algorithm="ring")))
    stats["ungated_allreduce_ms"] = wall_ms(
        lambda: b.allreduce(xs, algorithm="ring"))
    stats["consensus_round_host_us"] = host_us(
        lambda: h.consensus([1] * WS, proposer=p), n=50)
    stats["judged_round_host_us"] = host_us(
        lambda: native.run_judged_proposal(WS, b"{}", p), n=50)
    stats["python_judged_round_host_us"] = host_us(
        lambda: run_judged_proposal(WS, b"{}", p), n=50)
    print(f"[bridge] 256 MB allreduce (ring) wall: gated "
          f"{stats['gated_allreduce_ms']:.3f} ms, ungated "
          f"{stats['ungated_allreduce_ms']:.3f} ms; one consensus round "
          f"at ws {WS} (the facade's C engines) "
          f"{stats['consensus_round_host_us']:.1f} host us, one judged "
          f"round on a fresh world of C engines (the gate) "
          f"{stats['judged_round_host_us']:.1f} host us, of the Python "
          f"engines {stats['python_judged_round_host_us']:.1f} host us")
    del xs

    # (c) one gated round's engine events on the device and on the CPU
    small = [torch.randn(1024, generator=gen, device=dev)
             for _ in range(WS)]

    def events(backend, ys):
        native.trace_clear()
        native.trace_set(True)
        try:
            d, _ = backend.propose_collective(
                "allreduce", ys, proposer=p, device_judge=finite,
                algorithm="ring")
        finally:
            native.trace_set(False)
        evs = [(e["kind"], e["rank"], e["a"], e["b"], e["c"], e["d"])
               for e in native.trace_drain()]
        native.trace_clear()
        check(d == 1, "the traced round was vetoed")
        return evs
    on_dev = gated_call(lambda: events(h, small))
    on_cpu = events(HybridBackend(world_size=WS, device="cpu"),
                    [t.cpu() for t in small])
    check(on_dev == on_cpu and len(on_dev) > 0,
          f"the round's C-engine events on {dev} differ from the CPU's")
    check(stats["k1_gated_launches"] > 0,
          "K1 was not launched on the gated path")
    stats["trace_events"] = len(on_dev)
    print(f"[bridge] one gated ws-{WS} round's C-engine events (kind, "
          f"rank, a, b, c, d; the C core's trace ring): {len(on_dev)} on "
          f"{dev}, equal to the CPU's")
    h.close()
    b.close()
    return stats


def phase_multihost(dev) -> dict:
    """(b) ``MULTIHOST['procs']`` processes, each a ``MultiHostContext``
    (engine over the TCP transport, gloo data group) on ``dev``, run the
    multihost demo's rounds 1-4; every process must print its
    ``MULTIHOST-OK`` line within its time limit."""
    import os
    import shutil
    import tempfile

    nproc = MULTIHOST["procs"]
    tmp = tempfile.mkdtemp(prefix="rlo_multihost_")
    store = os.path.join(tmp, "store")
    cmd = [sys.executable, os.path.abspath(__file__), "--multihost-worker"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + [str(r), str(nproc), store, dev.type],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(nproc)]
    outs = []
    try:
        for r, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=max(
                    1.0, MULTIHOST["timeout_s"] - (time.perf_counter()
                                                   - t0)))
            except subprocess.TimeoutExpired:
                check(False, f"multihost process {r} hung past "
                      f"{MULTIHOST['timeout_s']} s")
            outs.append((proc.returncode, out, err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    for r, (rc, out, err) in enumerate(outs):
        check(rc == 0, f"multihost process {r} exited {rc}: "
              f"{err.strip()[-2000:]}")
    lines = [ln for _, out, _ in outs for ln in out.splitlines()
             if ln.startswith("MULTIHOST-OK")]
    check(len(lines) == nproc, f"{len(lines)} of {nproc} processes printed "
          f"MULTIHOST-OK")
    want = float(sum(range(1, nproc + 1)))
    rounds = {}
    for ln in lines:
        check(f"sum={want}" in ln and f"device={dev.type}" in ln,
              f"wrong multihost line: {ln}")
        for item in ln.split("round_ms=")[1].split()[0].split(","):
            k, v = item.split(":")
            rounds.setdefault(k, []).append(float(v))
        print(f"[multihost] {ln}")
    stats = {"procs": nproc, "wall_s": wall,
             "round_ms_max": {k: max(v) for k, v in rounds.items()},
             "round_ms_min": {k: min(v) for k, v in rounds.items()}}
    print(f"[multihost] {nproc} processes on one {dev.type} device, each "
          f"a MultiHostContext: engine over the TCP transport, data group "
          f"gloo (NCCL puts no two ranks on one card; gloo's all-reduce "
          f"takes a host copy of the card's tensor), local tensors and "
          f"judges on the card; rounds 1-4 passed on every process in "
          f"{wall:.1f} s; round ms (slowest process) "
          f"{json.dumps(stats['round_ms_max'])}")
    return stats


def multihost_worker(argv) -> int:
    """One process of ``phase_multihost``: rank, world size, store path,
    device type."""
    rank, ws, store, devtype = int(argv[0]), int(argv[1]), argv[2], argv[3]
    import torch
    if devtype == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device in a multihost process",
              file=sys.stderr)
        return 2
    import torch.distributed as dist
    from rlo_tpu_torch.parallel.multihost import MultiHostContext
    from rlo_tpu_torch.tools.multihost_demo import ok_line, run
    ctx = MultiHostContext(store=dist.FileStore(store, ws), rank=rank,
                           world_size=ws, data_backend="gloo",
                           device=None if devtype == "cuda" else devtype,
                           timeout=MULTIHOST["timeout_s"] / 2)
    try:
        res = run(ctx)
        check(ctx.device.type == devtype, f"context on {ctx.device}")
        print(f"{ok_line(ctx, res)} device={ctx.device}", flush=True)
    finally:
        ctx.close()
    return 0


# ---------------------------------------------------------------------------
# Phase 16: sequence-, tensor- and expert-parallel training, four processes
# on the card
# ---------------------------------------------------------------------------

#: phase 16's processes (ranks over gloo on the one card), its time limit
#: and the steps each sub-phase times (all from the same params)
TRAIN_PARALLEL = dict(procs=4, timeout_s=300.0, reps=3)
#: (tag, mesh shape, axis names, changes to the flagship config)
TRAIN_PARALLEL_RUNS = (
    ("16a sp 4 ring", (4,), ("sp",), {}),
    ("16b sp 4 Ulysses", (4,), ("sp",), {"sp_attention": "ulysses"}),
    ("16c tp 4", (4,), ("tp",), {}),
    ("16d sp 2 x tp 2 ring", (2, 2), ("sp", "tp"), {}),
    ("16e ep 4 MoE", (4,), ("ep",), {"dtype": "float32"}),
)
#: the ring step's operands for K4/K5: 64 folded heads x 256 x 64 bf16
RING_STEP = dict(heads=64, blk=256, shard=1)


def ring_step_bwd(dev) -> dict:
    """K2, K4 and K5 at a ring step's shapes: 64 folded heads x 256 x 64
    bf16, causal, the queries of shard 1 (positions 256..511), the state
    carried from their own block; then a block from an earlier shard
    (0..255: every key visible) and one from a later shard (512..767:
    every key masked). K4/K5 against their plain versions on the same
    operands (each side on its own forward's m', rtol 1e-4 per unit of
    the largest |value|, as phase 7); for the masked block K2 must leave
    (m, l, o) as they were, dk and dv must be exactly zero and dq equal
    to its plain version (zero too)."""
    import torch
    from rlo_tpu_torch.kernels import flash as kf
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    h, n, d, scale = RING_STEP["heads"], RING_STEP["blk"], 64, 0.125

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def pos(shard):
        return (shard * n + torch.arange(n, dtype=torch.int32,
                                         device=dev)).reshape(1, n)

    q = rand(h, n, d, dtype=torch.bfloat16)
    qp = pos(RING_STEP["shard"])
    m0 = torch.full((h, 1, n), kf.NEG, device=dev)
    l0, o0 = torch.zeros(h, 1, n, device=dev), torch.zeros(h, n, d,
                                                           device=dev)
    kw = dict(causal=True, scale=scale)
    with torch.no_grad():
        own = (rand(h, n, d, dtype=torch.bfloat16),
               rand(h, n, d, dtype=torch.bfloat16))
        state = kf.flash_block_update_hld(q, *own, m0, l0, o0, qp, qp, **kw)
        state_p = kf.flash_block_update_hld_plain(q, *own, m0, l0, o0, qp,
                                                  qp, **kw)
    out = {}
    for name, shard in (("earlier shard", 0), ("later shard", 2)):
        k, v = (rand(h, n, d, dtype=torch.bfloat16) for _ in range(2))
        kp = pos(shard)
        with torch.no_grad():
            nxt = kf.flash_block_update_hld(q, k, v, *state, qp, kp, **kw)
            m2p = kf.flash_block_update_hld_plain(q, k, v, *state_p, qp, kp,
                                                  **kw)[0]
        dl2, do2 = rand(h, 1, n), rand(h, n, d)
        route = torch.zeros(h, 1, n, device=dev)   # 'pallas_fast'
        dq = kf.bwd_dq(q, k, v, nxt[0], dl2, do2, route, qp, kp, **kw)
        dk, dv = kf.bwd_dkv(q, k, v, nxt[0], dl2, do2, route, qp, kp, **kw)
        pops = (q, k, v, m2p, dl2, do2, route, qp, kp)
        pdq, (pdk, pdv) = kf.bwd_dq_plain(*pops, **kw), \
            kf.bwd_dkv_plain(*pops, **kw)
        torch.cuda.synchronize()
        errs = {}
        for what, g, w in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
            check(bool(torch.isfinite(g).all()) and _close(g, w, 1e-4, 1e-4),
                  f"ring step, {name}: {what} differs from its plain "
                  f"version")
            errs[what] = abs_err(g, w)
        if shard > RING_STEP["shard"]:
            nonzero = {w: int(torch.count_nonzero(t)) for w, t in
                       (("dq", dq), ("dk", dk), ("dv", dv))}
            check(nonzero["dk"] == nonzero["dv"] == 0,
                  f"ring step, {name}: K5 left {nonzero['dk']} nonzero dk "
                  f"and {nonzero['dv']} nonzero dv in a fully masked block")
            check(torch.equal(dq, pdq), f"ring step, {name}: K4's dq is not "
                                        f"its plain version's")
            check(all(torch.equal(a, b) for a, b in zip(nxt, state)),
                  f"ring step, {name}: K2 changed the carried state")
            errs["nonzero"] = nonzero
        out[name] = errs
        print(f"[train-parallel] 16f ring step, {name} ({h} folded heads x "
              f"{n} x {d} bf16, queries at {int(qp[0, 0])}..., keys at "
              f"{int(kp[0, 0])}...): K4/K5 within rtol 1e-4 of their plain "
              f"versions, max |err| dq {errs['dq']:.3g}, dk "
              f"{errs['dk']:.3g}, dv {errs['dv']:.3g}"
              + (f"; dk and dv exactly zero, dq equal to its plain version "
                 f"({nonzero['dq']} nonzero), K2's state unchanged"
                 if "nonzero" in errs else ""))
    return out


def _train_parallel_plan(dev, tmp) -> dict:
    """The single-card step of each config on the card (phase 9's path,
    one SGD step at SGD_LR on the global batch) and the plan the worker
    processes read: each sub-phase's config, mesh, seeds and the path of
    its reference update (new - old per leaf, f32, saved on the host)."""
    import os
    import torch
    from rlo_tpu_torch.models import transformer as tt

    plan = {"lr": SGD_LR, "reps": TRAIN_PARALLEL["reps"],
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "runs": []}
    refs = {}
    for tag, shape, names, change in TRAIN_PARALLEL_RUNS:
        moe = "ep" in names
        cfg = dict(SERVE_CFG, **change)
        if moe:   # phase 12's widths, drop-free
            cfg.update(n_experts=MOE_EXPERTS,
                       capacity_factor=float(MOE_EXPERTS))
        seed = SEED + 15 if moe else SEED
        key = "moe" if moe else "dense"
        if key not in refs:   # sp_attention changes nothing on one card
            c = tt.TransformerConfig(**cfg)
            params = tt.init_params(c, seed=seed, device=dev)
            gen = torch.Generator(device=dev).manual_seed(SEED + 18)
            tokens = torch.randint(0, c.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                                   generator=gen, device=dev,
                                   dtype=torch.int32)
            new, loss = tt.train_step(params, tokens, c, lr=SGD_LR)
            path = os.path.join(tmp, f"ref_{key}.pt")
            torch.save([(n - o).cpu() for n, o in zip(
                tt.tree_leaves(new), tt.tree_leaves(params))], path)
            refs[key] = (path, float(loss))
            del params, new
            torch.cuda.empty_cache()
        plan["runs"].append(dict(tag=tag, shape=list(shape),
                                 names=list(names), cfg=cfg, seed=seed,
                                 token_seed=SEED + 18, ref=refs[key][0],
                                 ref_loss=refs[key][1]))
    plan["count_plain"] = dev.type == "cpu"
    return plan


def _rank_processes(dev, plan_fn, flag: str, nproc: int, timeout_s: float,
                    phase: int, line_tag: str):
    """Make a phase's plan (``plan_fn(dev, tmp)``, its JSON written to a
    temp dir), run ``nproc`` processes ``chip_smoke.py flag RANK WS STORE
    DEVTYPE PLAN`` to their end within ``timeout_s`` (any left is
    killed), and return (plan, the JSON of their ``line_tag`` lines, the
    plan's seconds, the processes' seconds). A process that hangs or
    exits non-zero fails the phase."""
    import os
    import shutil

    tmp = tempfile.mkdtemp(prefix=f"rlo_phase{phase}_")
    t0 = time.perf_counter()
    try:
        plan = plan_fn(dev, tmp)
        t_plan = time.perf_counter() - t0
        plan_path = os.path.join(tmp, "plan.json")
        with open(plan_path, "w") as f:
            json.dump(plan, f)
        cmd = [sys.executable, os.path.abspath(__file__), flag]
        t1 = time.perf_counter()
        procs = [subprocess.Popen(cmd + [str(r), str(nproc),
                                         os.path.join(tmp, "store"),
                                         dev.type, plan_path],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(nproc)]
        outs = []
        try:
            for r, proc in enumerate(procs):
                try:
                    out, err = proc.communicate(timeout=max(
                        1.0, timeout_s - (time.perf_counter() - t1)))
                except subprocess.TimeoutExpired:
                    check(False, f"phase-{phase} process {r} hung past "
                          f"{timeout_s} s")
                outs.append((proc.returncode, out, err))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        t_procs = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r, (rc, out, err) in enumerate(outs):
        check(rc == 0, f"phase-{phase} process {r} exited {rc}: "
              f"{err.strip()[-3000:]}")
    lines = [json.loads(ln.split(" ", 1)[1]) for _, out, _ in outs
             for ln in out.splitlines() if ln.startswith(line_tag + " ")]
    return plan, lines, t_plan, t_procs


def _leaf_slices(got, tag):
    """Per leaf, the relative L2 of the processes' (result - reference)
    over the leaf's distinct slices (each process's ``diff`` and ``ref``
    sums of squares), and the count of replicated copies; fails where two
    processes holding one slice differ in its bits (``digest``)."""
    rel, copies = [], 0
    for i in range(len(got[0]["leaves"])):
        slices = {}
        for x in got:
            leaf = x["leaves"][i]
            slices.setdefault(tuple(leaf["key"]), []).append(leaf)
        for key, held in slices.items():
            check(all(h["digest"] == held[0]["digest"] for h in held),
                  f"{tag}: leaf {i} slice {key} differs between the "
                  f"processes that hold it")
            copies += len(held) - 1
        diff = sum(h[0]["diff"] for h in slices.values())
        ref = sum(h[0]["ref"] for h in slices.values())
        rel.append(math.sqrt(diff / max(ref, 1e-300)))
    return rel, copies


def _digest(t) -> list:
    """Two integer sums of a tensor's bits (plain and position-weighted):
    equal for equal bits, apart on any one element's change."""
    import torch
    b = t.detach().contiguous().view(torch.int32).reshape(-1).long()
    w = torch.arange(b.numel(), device=b.device) % 65521 + 1
    return [int(b.sum()), int((b * w).sum())]


def train_parallel_worker(argv) -> int:
    """One process of phase 16: rank, world size, store path, device
    type, plan path. Runs every sub-phase of the plan as one rank over
    gloo on ``dist_mesh_axes``, and prints a ``TRAIN-PARALLEL`` JSON
    line for each."""
    rank, ws, store, devtype, plan_path = (int(argv[0]), int(argv[1]),
                                           argv[2], argv[3], argv[4])
    import torch
    if devtype == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device in a phase-16 process",
              file=sys.stderr)
        return 2
    from datetime import timedelta

    import torch.distributed as dist
    from rlo_tpu_torch.kernels import flash as kf
    from rlo_tpu_torch.models import transformer as tt
    from rlo_tpu_torch.parallel.mesh import dist_mesh_axes
    from rlo_tpu_torch.parallel.sharding import leaf_specs, shard_tree

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    with open(plan_path) as f:
        plan = json.load(f)
    counted = (kf.flash_block_update_hld, kf.bwd_dq, kf.bwd_dkv)
    if plan["count_plain"]:
        # a rehearsal on the CPU: the plain versions count in their
        # wrappers' place
        for plain, wrapper in zip(("flash_block_update_hld_plain",
                                   "bwd_dq_plain", "bwd_dkv_plain"),
                                  counted):
            def bump(*a, _orig=getattr(kf, plain), _w=wrapper, **kw):
                _w.launches += 1
                return _orig(*a, **kw)
            setattr(kf, plain, bump)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if devtype == "cuda" else torch.device("cpu")
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, ws), rank=rank, world_size=ws,
        timeout=timedelta(seconds=TRAIN_PARALLEL["timeout_s"] / 2))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    try:
        for run in plan["runs"]:
            axes = dist_mesh_axes(run["shape"], run["names"], device=dev)
            cfg = tt.TransformerConfig(**run["cfg"])
            specs = tt.param_pspecs(cfg, "tp" if "tp" in axes else None,
                                    "ep" if "ep" in axes else None)
            full = tt.init_params(cfg, seed=run["seed"], device=dev)
            params = shard_tree(full, specs, axes)
            gen = torch.Generator(device=dev).manual_seed(run["token_seed"])
            tokens = torch.randint(0, cfg.vocab, (plan["batch"],
                                                  plan["seq"]),
                                   generator=gen, device=dev,
                                   dtype=torch.int32)
            del full
            if "ep" in axes:
                rows = plan["batch"] // axes["ep"].size
                tokens = tokens[axes["ep"].index * rows:
                                (axes["ep"].index + 1) * rows]
            if "sp" in axes:
                blk = plan["seq"] // axes["sp"].size
                tokens = tokens[:, axes["sp"].index * blk:
                                (axes["sp"].index + 1) * blk]
            tokens = tokens.contiguous()
            kw = {f"{n}_axis": a for n, a in axes.items()}
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            walls = []
            for i in range(plan["reps"]):
                staged0 = sum(a.staged_bytes for a in axes.values())
                for fn in (*counted, kf.bwd_dkv_prep):
                    fn.launches = 0
                sync()
                t0 = time.perf_counter()
                new, loss = tt.train_step(params, tokens, cfg, lr=plan["lr"],
                                          **kw)
                sync()
                walls.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    first = (new, loss)
                    launches = {fn.__name__: fn.launches for fn in counted}
                    prep_launches = kf.bwd_dkv_prep.launches
                    staged = sum(a.staged_bytes
                                 for a in axes.values()) - staged0
                del new
            new, loss = first
            peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
                if dev.type == "cuda" else 0.0
            ref = torch.load(run["ref"], mmap=True)
            ref = shard_tree(tt._rebuild(params, iter(ref)), specs, axes)
            leaves = []
            for n, o, r, spec in zip(tt.tree_leaves(new),
                                     tt.tree_leaves(params),
                                     tt.tree_leaves(ref),
                                     leaf_specs(params, specs)):
                r = r.to(dev)
                u = (n - o).double()
                leaves.append(dict(
                    key=[axes[a].index for a in spec if a is not None],
                    diff=float((u - r.double()).square().sum()),
                    ref=float(r.double().square().sum()),
                    digest=_digest(n)))
            print("TRAIN-PARALLEL " + json.dumps(dict(
                tag=run["tag"], rank=rank, loss=float(loss), walls=walls,
                peak_gib=peak, staged_bytes=staged, launches=launches,
                prep_launches=prep_launches, leaves=leaves)), flush=True)
            del params, new, first, ref, leaves
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def phase_train_parallel(dev) -> dict:
    """Sequence-, tensor- and expert-parallel training at full width (16a
    -16e), each rank a process over gloo on the one card (a backward
    collective needs each rank's backward on a thread of its own, which
    one card's ``LocalMesh`` cannot give, and NCCL puts no two ranks on
    one card): ``TRAIN_PARALLEL['procs']`` processes ``chip_smoke.py
    --train-parallel-worker``, their params, activations and kernels on
    the card, their collectives through host buffers. Each sub-phase
    takes one SGD step at SGD_LR (timed ``reps`` times from the same
    params) on phase 9's global batch, each process its block, held
    against the single-card ``train_step`` on the same batch run here:
    the loss within PIPE_LOSS_RTOL, the update (new - old) within
    DP_REL_LIMIT relative L2 per tensor, every process's loss the same
    bits, every replicated leaf the same bits on every process holding
    it, and K2, K4 and K5 launched the path's own count a step on every
    process (layers x ring steps), K5's prepass once a bf16 K5 launch.
    Then 16f: K4/K5 at a ring step's shapes (``ring_step_bwd``)."""
    nproc = TRAIN_PARALLEL["procs"]
    plan, lines, t_ref, t_procs = _rank_processes(
        dev, _train_parallel_plan, "--train-parallel-worker", nproc,
        TRAIN_PARALLEL["timeout_s"], 16, "TRAIN-PARALLEL")
    stats = {}
    for run in plan["runs"]:
        tag, names, cfg = run["tag"], run["names"], run["cfg"]
        got = sorted((x for x in lines if x["tag"] == tag),
                     key=lambda x: x["rank"])
        check(len(got) == nproc, f"{tag}: {len(got)} of {nproc} processes "
                                 f"reported")
        losses = [x["loss"] for x in got]
        check(len(set(losses)) == 1, f"{tag}: the processes' losses differ: "
                                     f"{losses}")
        lrel = abs(losses[0] - run["ref_loss"]) / abs(run["ref_loss"])
        check(math.isfinite(losses[0]) and lrel <= PIPE_LOSS_RTOL,
              f"{tag}: loss {losses[0]} against the single card's "
              f"{run['ref_loss']} (relative {lrel:.3g} > {PIPE_LOSS_RTOL})")
        rel, copies = _leaf_slices(got, tag)
        check(max(rel) <= DP_REL_LIMIT,
              f"{tag}: update differs from the single card's: max relative "
              f"L2 {max(rel):.3g} > {DP_REL_LIMIT}")
        ring = cfg.get("sp_attention", "ring") == "ring" and "sp" in names
        steps = run["shape"][names.index("sp")] if ring else 1
        want = cfg["n_layers"] * steps
        # K5's prepass: one launch a bf16 K5 launch (none on the CPU)
        bf16 = dev.type == "cuda" and cfg["dtype"] == "bfloat16"
        for x in got:
            check(x["launches"] == dict.fromkeys(x["launches"], want),
                  f"{tag}: process {x['rank']} launched {x['launches']} in "
                  f"a step, not {want} each")
            check(x["prep_launches"] == (want if bf16 else 0),
                  f"{tag}: process {x['rank']} launched K5's prepass "
                  f"{x['prep_launches']} times in a step, not "
                  f"{want if bf16 else 0}")
        walls = [statistics.median(x["walls"]) for x in got]
        st = dict(loss=losses[0], loss_rel=lrel, update_rel_l2_max=max(rel),
                  update_rel_l2_median=statistics.median(rel),
                  replicated_copies_equal=copies,
                  wall_ms_median=max(walls), wall_ms_min=min(walls),
                  peak_gib_max=max(x["peak_gib"] for x in got),
                  staged_bytes_per_step=max(x["staged_bytes"] for x in got),
                  launches_per_step=got[0]["launches"])
        stats[tag] = st
        print(f"[train-parallel] {tag} ({nproc} processes, mesh "
              f"{dict(zip(names, run['shape']))}, {cfg['dtype']}): loss "
              f"{losses[0]:.6f} on every process vs the single card's "
              f"{run['ref_loss']:.6f} (relative {lrel:.3g}); update "
              f"relative L2 per tensor max {max(rel):.3g}, median "
              f"{st['update_rel_l2_median']:.3g} (limit {DP_REL_LIMIT}); "
              f"{copies} replicated copies bit-identical; median wall a step "
              f"{st['wall_ms_median']:.1f} ms (slowest process; fastest "
              f"{st['wall_ms_min']:.1f}); peak device memory a process "
              f"{st['peak_gib_max']:.2f} GiB; bytes staged through the host "
              f"a step {st['staged_bytes_per_step']} a process; K2/K4/K5 "
              f"launches a step on every process "
              f"{json.dumps(st['launches_per_step'])}")
    stats["ring_step"] = ring_step_bwd(dev)
    stats["reference_s"] = t_ref
    stats["processes_s"] = t_procs
    print(f"[train-parallel] references on the card {t_ref:.1f} s, the "
          f"{nproc} processes {t_procs:.1f} s (start included)")
    return stats


# ---------------------------------------------------------------------------
# Phase 17: the serving fabric over the card's DecodeServers
# ---------------------------------------------------------------------------

#: phase 17's fleets: the model-backed fleet of tests/test_fabric.py at
#: the flagship's width, ``ranks`` DecodeServers in the port's simulator,
#: ``requests`` through every gateway in turn from virtual t = 0.5 a
#: quarter second apart, the busiest rank killed at the first pump at
#: ``kill_at`` virtual s, drained by ``deadline`` virtual s. A dense
#: prompt of 384 passes the largest bucket: its admission extends the
#: bucket's prefill (K2) with a 128-token block_decode chunk (K6 over the
#: chunk, K8 writing it), the only dense admission that launches K8
FABRIC = dict(ranks=4, requests=32, kill_at=3.0, deadline=120.0,
              n_slots=8, max_len=512, round_len=16, buckets=(64, 256),
              plens=(64, 128, 256, 384), max_new=(32, 64), page_size=128,
              prefixes=4, prefix_len=256, tails=(32, 64, 128))
FABRIC_ENGINE = dict(failure_timeout=6.0, heartbeat_interval=1.0,
                     arq_rto=1.5, arq_max_retries=6, op_deadline=20.0)


def fabric_requests(vocab: int, rng, paged: bool):
    """Phase 17's requests, [(virtual t, gateway, prompt, max_new)]:
    request i arrives at t = 0.5 + 0.25 i through gateway i % ranks with
    max_new from FABRIC['max_new']. Dense prompts have a length drawn
    from FABRIC['plens']; paged ones are one of FABRIC['prefixes'] shared
    256-token prefixes and a tail of a length drawn from FABRIC['tails'],
    half of the tails cut from that prefix's one 128-token stem (a tail
    that begins with a registered one maps the registered partial page
    and copies it before writing: copy-on-write), half random."""
    import numpy as np
    F = FABRIC
    prefixes = [rng.integers(0, vocab, F["prefix_len"])
                for _ in range(F["prefixes"])]
    stems = [rng.integers(0, vocab, max(F["tails"]))
             for _ in range(F["prefixes"])]
    out = []
    for i in range(F["requests"]):
        if paged:
            k = int(rng.integers(0, F["prefixes"]))
            n = int(rng.choice(F["tails"]))
            tail = (stems[k][:n] if rng.random() < 0.5
                    else rng.integers(0, vocab, n))
            p = np.concatenate([prefixes[k], tail])
        else:
            p = rng.integers(0, vocab, int(rng.choice(F["plens"])))
        m = int(rng.integers(F["max_new"][0], F["max_new"][1] + 1))
        out.append((0.5 + 0.25 * i, i % F["ranks"],
                    tuple(int(t) for t in p), m))
    return out


def fabric_fleet(dev, params, cfg, paged: bool, reqs, seed: int,
                 tracer=None) -> dict:
    """One fleet run: ``FABRIC['ranks']`` ranks of the port's SimWorld,
    one EngineManager, a ProgressEngine and a DecodeFabric over a
    ModelBackend(DecodeServer) on each, the servers sharing one cast set
    of weights. Requests go in through their gateways at their virtual
    times (through the next live rank once a gateway is dead); at the
    first pump at virtual t >= FABRIC['kill_at'] the rank holding the
    most active requests is killed, its engine cleaned up and its server
    released; the loop drains until every request has a result on every
    live rank or the virtual deadline passes. The virtual clock moves
    only through the simulator's event queue, so the schedule is the
    seed's whatever the card's wall time. With a ``tracer``, each rank's
    fabric records every request's spans into it (a SpanRecorder a rank,
    on the fleet's seed)."""
    import gc

    import torch
    from rlo_tpu_torch.engine import EngineManager, ProgressEngine
    from rlo_tpu_torch.models import serve as S
    from rlo_tpu_torch.observe.spans import SpanRecorder
    from rlo_tpu_torch.serving.backend import ModelBackend
    from rlo_tpu_torch.serving.fabric import DecodeFabric, fleet_stats
    from rlo_tpu_torch.transport.sim import SimWorld
    from rlo_tpu_torch.utils.metrics import Registry

    F = FABRIC
    n = F["ranks"]
    kw = (dict(paged=True, page_size=F["page_size"]) if paged
          else dict(prompt_buckets=F["buckets"]))
    world = SimWorld(n, seed=seed)
    mgr = EngineManager()
    engines = [ProgressEngine(world.transport(r), manager=mgr,
                              clock=world.clock, **FABRIC_ENGINE)
               for r in range(n)]
    servers = [S.DecodeServer(params, cfg, n_slots=F["n_slots"],
                              max_len=F["max_len"],
                              round_len=F["round_len"], metrics=Registry(),
                              **kw) for _ in range(n)]
    for srv in servers:
        check(srv.device.type == dev.type,
              f"a fleet server landed on {srv.device}, not {dev.type}")
        check(srv.params["embed"] is params["embed"],
              "the fleet's servers do not share one set of weights")
    spans = [None if tracer is None else SpanRecorder(
        r, world.clock, seed=seed, tracer=tracer) for r in range(n)]
    fabrics = [DecodeFabric(engines[r], ModelBackend(servers[r]),
                            decode_interval=1.0, spans=spans[r])
               for r in range(n)]
    live = set(range(n))
    rids = [None] * len(reqs)
    redirected, killed, victim = 0, False, None
    victim_stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nxt = 0
    while world.now < F["deadline"]:
        while nxt < len(reqs) and world.now >= reqs[nxt][0]:
            _, gw, prompt, m = reqs[nxt]
            if gw not in live:
                gw = min(live, key=lambda r: (r - gw) % n)
                redirected += 1
            rids[nxt] = fabrics[gw].submit(prompt, m)
            nxt += 1
        if not killed and world.now >= F["kill_at"]:
            killed = True
            victim = max(sorted(live), key=lambda r: len(
                fabrics[r].backend.active_keys()))
            victim_stats = dict(
                active=len(fabrics[victim].backend.active_keys()),
                rounds=servers[victim].rounds_run,
                counters=servers[victim].stats()["counters"],
                at_virtual_s=world.now)
            world.kill_rank(victim)
            engines[victim].cleanup()
            live.discard(victim)
            # the dead rank's server and its cache go: nothing pumps it
            fabrics[victim].backend.server = None
            servers[victim] = None
            gc.collect()
            torch.cuda.empty_cache()
        world.step()
        mgr.progress_all()
        for r in sorted(live):
            fabrics[r].pump()
        if nxt == len(reqs) and killed and all(
                fabrics[r].result(rid) is not None
                for r in live for rid in rids):
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ranks = sorted(live)
    check(killed and len(ranks) == n - 1, "no rank was killed")
    for r in ranks:
        f = fabrics[r]
        for i, rid in enumerate(rids):
            check(f.result(rid) is not None,
                  f"request {i} {rid} has no result on rank {r} by virtual "
                  f"t {world.now:.2f}")
            check(f.completions.count(rid) == 1,
                  f"request {i} completed {f.completions.count(rid)} times "
                  f"on rank {r}")
            check(f.result(rid) == fabrics[ranks[0]].result(rid),
                  f"request {i}'s tokens differ between ranks {ranks[0]} "
                  f"and {r}")
        check(f.dup_done == 0, f"rank {r} decoded {f.dup_done} requests "
                               f"that completed elsewhere")
    results = [fabrics[ranks[0]].result(rid) for rid in rids]
    for i, (_, _, _, m) in enumerate(reqs):
        check(len(results[i]) == m, f"request {i}: {len(results[i])} "
                                    f"tokens, wanted {m}")
    fs = fleet_stats([fabrics[r] for r in ranks])
    requeues = sum(fabrics[r].requeues for r in ranks)
    counters = {}
    for r in ranks:
        for k, v in servers[r].stats()["counters"].items():
            counters[k] = counters.get(k, 0) + v
    for k, v in victim_stats.get("counters", {}).items():
        counters[k] = counters.get(k, 0) + v
    out = dict(
        wall_s=wall, virtual_s=world.now, victim=victim,
        victim_active=victim_stats["active"],
        killed_at_virtual_s=victim_stats["at_virtual_s"],
        redirected=redirected, requeues=requeues,
        dup_done=sum(fabrics[r].dup_done for r in ranks),
        rounds={str(r): servers[r].rounds_run for r in ranks}
        | {str(victim): victim_stats["rounds"]},
        tokens=sum(len(t) for t in results),
        prefix_hits=counters.get("serve.prefix_hits", 0),
        cow_copies=counters.get("serve.cow_copies", 0),
        e2e_usec_virtual={q: fs["e2e_usec"][q]
                          for q in ("count", "p50", "p99")},
        queue_wait_usec_virtual={q: fs["queue_wait_usec"][q]
                                 for q in ("count", "p50", "p99")},
        digest=world.schedule_digest(), results=results)
    out["tok_per_s_wall"] = out["tokens"] / wall
    for e in engines:
        e.cleanup()
    return out


def fabric_oracle(params, cfg, reqs, results, what) -> int:
    """Every completion against its prompt's own greedy ``generate``
    (``greedy_with_gaps``, one batched call a prompt length), by phase
    5's rule: equal up to a parting at a near-tie. Returns how many
    compared to the end."""
    import numpy as np
    import torch
    dev = params["embed"].device
    by_len = {}
    for i, (_, _, p, _) in enumerate(reqs):
        by_len.setdefault(len(p), []).append(i)
    full = 0
    for plen, idx in sorted(by_len.items()):
        prompt = torch.as_tensor(np.array([reqs[i][2] for i in idx],
                                          np.int32), device=dev)
        toks, gaps = greedy_with_gaps(params, prompt, cfg,
                                      max(reqs[i][3] for i in idx))
        for j, i in enumerate(idx):
            m = reqs[i][3]
            upto, done = compare_until_near_tie(
                np.asarray(results[i]), toks[j, :m], gaps[j, :m])
            full += done
            if not done:
                print(f"[fabric] {what} request {i} (plen {plen}): tokens "
                      f"part from its generate at position {upto} of {m}, "
                      f"a near-tie (scaled top-2 gap {gaps[j, upto]:.4g})")
    return full


#: the facts of a fleet run that its span recorders must leave as they
#: are (their trailers change the record bytes, and with them the
#: schedule digest, which hashes the bytes)
FLEET_DECISIONS = ("victim", "killed_at_virtual_s", "virtual_s",
                   "redirected", "requeues", "dup_done", "rounds",
                   "results", "e2e_usec_virtual", "queue_wait_usec_virtual")


def fabric_spans(dev, params, cfg, reqs, unrecorded, span_dir) -> dict:
    """17a once more with a SpanRecorder on every rank (every request
    traced): the decisions must equal the unrecorded run's; each rank's
    spans are dumped to ``span_dir`` as JSON lines for phase 19."""
    import os
    from rlo_tpu_torch.utils.tracing import Tracer
    tracer = Tracer(capacity=1 << 22, enabled=True)
    rec = fabric_fleet(dev, params, cfg, False, reqs, SEED + 17,
                       tracer=tracer)
    for k in FLEET_DECISIONS:
        check(rec[k] == unrecorded[k], f"17a with span recorders: {k} "
              f"differs from the unrecorded fleet's")
    check(tracer.dropped == 0, f"the span ring dropped {tracer.dropped}")
    events = [tracer.dump_jsonl(os.path.join(span_dir,
                                             f"spans.rank{r}.jsonl"), rank=r)
              for r in range(FABRIC["ranks"])]
    print(f"[fabric] 17a fleet with a SpanRecorder a rank: decisions "
          f"equal the unrecorded run's ({', '.join(FLEET_DECISIONS)}); "
          f"{sum(events)} span events dumped, by rank {events}; wall "
          f"{rec['wall_s']:.2f} s")
    return {"wall_s": rec["wall_s"], "span_events": events}


def phase_fabric(dev, counted, span_dir=None) -> dict:
    """Phase 17: the rootless serving fabric over fleets of full-width
    DecodeServers on the card. (a) a dense fleet and (b) a paged one
    (``fabric_fleet``), the ``counted`` kernels' launch counts set to 0
    just before each fleet's run and read just after it: K2, K6, K7 and
    K8 must launch in (a), K9, K10 and K11 in (b). Every request
    completes exactly once on every live rank with the same tokens there,
    at least one is re-queued by the fail-over, and every completion
    equals its prompt's own generate but at a near-tie. (a) runs a second
    time on the same seed: whether its schedule digest and tokens repeat
    is printed. With a ``span_dir``, (a) runs a third time with span
    recorders (``fabric_spans``)."""
    import numpy as np
    import torch
    from rlo_tpu_torch.models.transformer import (TransformerConfig,
                                                  cast_params, init_params)

    cfg = TransformerConfig(**SERVE_CFG)
    params = cast_params(init_params(cfg, seed=SEED + 17, device=dev),
                         cfg.act_dtype)
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for tag, paged, must in (
            ("17a dense", False, ("flash_block_update_hld",
                                  "flash_block_decode", "write_kv_row",
                                  "write_kv_block")),
            ("17b paged", True, ("paged_flash_decode", "write_kv_page_row",
                                 "write_kv_page_block"))):
        rng = np.random.default_rng(SEED + 17 + paged)
        reqs = fabric_requests(cfg.vocab, rng, paged)
        for fn in counted:
            fn.launches = 0
        st = fabric_fleet(dev, params, cfg, paged, reqs, SEED + 17)
        launches = {fn.__name__: fn.launches for fn in counted}
        for name in must:
            check(launches[name] > 0,
                  f"{name} was not launched on the {tag} fleet's path")
        check(st["requeues"] >= 1, f"the {tag} fleet re-queued nothing "
                                   f"after the kill")
        st["launches"] = launches
        t0 = time.perf_counter()
        st["compared_to_end"] = fabric_oracle(params, cfg, reqs,
                                              st["results"], tag)
        oracle_s = time.perf_counter() - t0
        if not paged:
            again = fabric_fleet(dev, params, cfg, paged, reqs, SEED + 17)
            st["rerun_same_digest"] = again["digest"] == st["digest"]
            st["rerun_same_tokens"] = again["results"] == st["results"]
            st["rerun_wall_s"] = again["wall_s"]
            if span_dir is not None:
                st["recorded"] = fabric_spans(dev, params, cfg, reqs, st,
                                              span_dir)
        print(f"[fabric] {tag} fleet: {FABRIC['ranks']} ranks x "
              f"DecodeServer(n_slots={FABRIC['n_slots']}, max_len="
              f"{FABRIC['max_len']}, round_len={FABRIC['round_len']}, "
              + (f"paged, page_size={FABRIC['page_size']}" if paged else
                 f"buckets {FABRIC['buckets']}")
              + f"), {len(reqs)} requests; rank {st['victim']} killed at "
              f"virtual {st['killed_at_virtual_s']:.2f} s holding "
              f"{st['victim_active']} active requests ({st['redirected']} "
              f"later requests through the next live gateway); wall "
              f"{st['wall_s']:.2f} s, drained at virtual "
              f"{st['virtual_s']:.2f} s; {st['tokens']} tokens, "
              f"{st['tok_per_s_wall']:.0f} tok/s (wall); requeues "
              f"{st['requeues']}, dup_done {st['dup_done']}, prefix hits "
              f"{st['prefix_hits']}, COW copies {st['cow_copies']}; decode "
              f"rounds by rank {json.dumps(st['rounds'])}")
        print(f"[fabric] {tag} fleet: fabric e2e_usec and queue_wait_usec "
              f"in VIRTUAL time (the simulator's clock, not the card's): "
              f"e2e {json.dumps(st['e2e_usec_virtual'])}, queue wait "
              f"{json.dumps(st['queue_wait_usec_virtual'])}")
        print(f"[fabric] {tag} fleet: every request completed exactly once "
              f"on every live rank, same tokens there; against each "
              f"prompt's own generate {st['compared_to_end']} of "
              f"{len(reqs)} to the end, every parting at a near-tie "
              f"(oracle {oracle_s:.1f} s); launches {json.dumps(launches)}"
              + ("" if paged else
                 f"; a second run on the same seed: same schedule digest "
                 f"{st['rerun_same_digest']}, same tokens "
                 f"{st['rerun_same_tokens']} (wall {st['rerun_wall_s']:.2f}"
                 f" s)"))
        del st["results"]
        out[tag] = st
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[fabric] peak device memory over phase 17 "
          f"{out['peak_gib']:.2f} GiB (four servers' caches, one shared "
          f"set of weights)")
    return out


# ---------------------------------------------------------------------------
# Phase 18: the host facades (native, loopback, mpi, tcp) fed card tensors
# ---------------------------------------------------------------------------

#: 18a/18b (one process, world size WS): int32 elements of the 1 MB sum,
#: f32 elements of one all_to_all chunk, f32 elements of each facade's
#: bcast (native engines take 4 MB a frame, loopback's 32 KB), the
#: origin, the proposer, the rank that vetoes and the sub-group's members;
#: the f32 allreduce runs at the full size only for native's sum (the
#: GB/s of the BASELINE size), every other one at a eighth of it (32 MB a
#: rank: min, max and loopback re-measure the same copies and protocol)
HOST = dict(n_int=2 ** 18, n_a2a=2 ** 15, allreduce_cut=8,
            bcast={"native": 2 ** 18, "loopback": 2 ** 12},
            origin=5, proposer=3, veto=6, sub=(1, 3, 4, 6))
#: each facade's allreduce schedule for the f32 ops and the int32 sum
HOST_ALGS = {"native": ("ring", "bcast_gather"),
             "loopback": ("ring", "auto")}
#: 18c/18d (one process a rank on the card): ranks, time limit, f32
#: elements a rank of the all_gather and the sub-group's allreduce, the
#: sub-group, the proposer and the rank that vetoes (the ring allreduce
#: takes N_FULL a rank)
HOST_PROCS = dict(procs=4, timeout_s=300.0, n_small=2 ** 16, sub=(0, 2),
                  proposer=1, veto=2)


def _host_inputs(dev, ws, n, seed):
    """Rank r's f32 tensor on ``dev``: ``n`` normals from its own seeded
    generator, so another process makes the same bits."""
    import torch
    out = []
    for r in range(ws):
        gen = torch.Generator(device=dev).manual_seed(seed + r)
        out.append(torch.randn(n, generator=gen, device=dev))
    return out


def _host_digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()[:16]


def _held(what, got, want) -> None:
    """Every rank's result equals TorchBackend's bit for bit (see
    ``phase_host_facades`` for why each pair must) and lives where the
    caller's tensors do."""
    import torch
    flat_g = [g for row in got for g in row] if isinstance(got[0], list) \
        else list(got)
    flat_w = [w for row in want for w in row] \
        if isinstance(want[0], list) else list(want)
    check(len(flat_g) == len(flat_w), f"{what}: {len(flat_g)} results, "
          f"TorchBackend {len(flat_w)}")
    for i, (g, w) in enumerate(zip(flat_g, flat_w)):
        check(isinstance(g, torch.Tensor) and g.device == w.device,
              f"{what}: result {i} is {type(g).__name__} on "
              f"{getattr(g, 'device', None)}, not a tensor on {w.device}")
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{what}: result {i} {g.dtype} {tuple(g.shape)}, "
              f"TorchBackend {w.dtype} {tuple(w.shape)}")
        if not torch.equal(g, w):
            err = float((g.double() - w.double()).abs().max())
            check(False, f"{what}: result {i} differs from TorchBackend "
                  f"(max abs err {err})")


def _host_wall(dev, fn):
    """(result, wall ms) of ``fn()``, ending in a synchronise of ``dev``
    where it is a card."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def _host_op(dev, rows, tag, op, facade, nbytes, got_fn, want_fn):
    """Run one op on the facade and on TorchBackend, hold them, print
    and keep the facade's wall (staging and protocol) beside
    TorchBackend's wall and K1 launches."""
    from rlo_tpu_torch.kernels import reduce as k1
    facade.last_staging = None
    got, ms = _host_wall(dev, got_fn)
    st = facade.last_staging
    check(st is not None, f"{tag} {op}: the facade staged nothing")
    before = k1.fused_combine.launches
    want, want_ms = _host_wall(dev, want_fn)
    launches = k1.fused_combine.launches - before
    _held(f"{tag} {op}", got, want)
    row = {"ms": ms, "to_host_ms": st["to_host_s"] * 1e3,
           "protocol_ms": st["protocol_s"] * 1e3,
           "to_device_ms": st["to_device_s"] * 1e3,
           "bytes_a_rank": nbytes, "torch_ms": want_ms,
           "torch_k1_launches": launches}
    if op.startswith("allreduce f32"):
        row["gb_s"] = nbytes / (ms * 1e-3) / 1e9
    rows[op] = row
    rate = f", {row['gb_s']:.3f} GB/s a rank" if "gb_s" in row else ""
    print(f"[host] {tag} {op} ({nbytes} B a rank): {ms:.1f} ms = to host "
          f"{row['to_host_ms']:.1f} + protocol {row['protocol_ms']:.1f} + "
          f"to card {row['to_device_ms']:.1f}{rate}; TorchBackend "
          f"{want_ms:.1f} ms, K1 launches {launches}; equal bit for bit")
    return got


def phase_host_facades(dev, n_full: int) -> dict:
    """(a) ``init("native", world_size=WS)`` and (b) ``init("loopback")``
    fed per-rank tensors on ``dev``, every result held bit for bit
    against ``TorchBackend`` on the same tensors, op and world: the f32
    allreduce (sum, min, max) by the ring (C ring / ``Comm``'s ring
    against the device ring: both reduce each chunk in the same ring
    order, local + incoming, so their sums are the same float
    additions in the same order); the int32 sum at 1 MB (native by
    bcast-gather, loopback by ``Comm``'s ring: integer sums are exact in
    any order); reduce_scatter (ring, same order as the allreduce) and
    all_gather at n_full / WS; all_to_all; bcast from a non-zero
    origin; consensus with every vote YES and with one veto; barrier;
    and a 4-member ``sub_group`` (allreduce ring, consensus with a veto,
    bcast) against a 4-rank ``TorchBackend``. Results must be tensors on
    ``dev``. The f32 allreduce takes n_full a rank for native's sum and
    n_full / HOST['allreduce_cut'] otherwise."""
    import torch
    import rlo_tpu_torch
    from rlo_tpu_torch.backend import TorchBackend

    t_phase = time.perf_counter()
    torch_b = TorchBackend(world_size=WS, device=dev)
    xs = _host_inputs(dev, WS, n_full, SEED + 1800)
    n_rs = n_full // WS
    xs_rs = [x[:n_rs] for x in xs]
    n_cut = n_full // HOST["allreduce_cut"]
    xs_cut = [x[:n_cut] for x in xs]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1801)
    ints = [torch.randint(-2 ** 20, 2 ** 20, (HOST["n_int"],),
                          generator=gen, device=dev, dtype=torch.int32)
            for _ in range(WS)]
    grid = [[torch.randn(HOST["n_a2a"], generator=gen, device=dev)
             for _ in range(WS)] for _ in range(WS)]
    sub = list(HOST["sub"])
    sub_b = TorchBackend(world_size=len(sub), device=dev)
    stats = {}
    for name, tag in (("native", "18a native"), ("loopback",
                                                 "18b loopback")):
        t0 = time.perf_counter()
        alg_f32, alg_int = HOST_ALGS[name]
        rows = {}
        f = rlo_tpu_torch.init(name, world_size=WS)
        try:
            for op in ("sum", "min", "max"):
                ar = xs if (name, op) == ("native", "sum") else xs_cut
                _host_op(dev, rows, tag, f"allreduce f32 {op} {alg_f32}",
                         f, 4 * ar[0].numel(),
                         lambda: f.allreduce(ar, op=op, algorithm=alg_f32),
                         lambda: torch_b.allreduce(ar, op=op,
                                                   algorithm="ring"))
            _host_op(dev, rows, tag, f"allreduce int32 sum {alg_int}", f,
                     4 * HOST["n_int"],
                     lambda: f.allreduce(ints, algorithm=alg_int),
                     lambda: torch_b.allreduce(ints))
            _host_op(dev, rows, tag, "reduce_scatter f32 sum ring", f,
                     4 * n_rs, lambda: f.reduce_scatter(xs_rs),
                     lambda: torch_b.reduce_scatter(xs_rs,
                                                    algorithm="ring"))
            _host_op(dev, rows, tag, "all_gather f32", f, 4 * n_rs,
                     lambda: f.all_gather(xs_rs),
                     lambda: torch_b.all_gather(xs_rs))
            _host_op(dev, rows, tag, "all_to_all f32", f,
                     4 * HOST["n_a2a"] * WS,
                     lambda: f.all_to_all(grid),
                     lambda: torch_b.all_to_all(grid))
            xb = xs[HOST["origin"]][:HOST["bcast"][name]]
            _host_op(dev, rows, tag, f"bcast from {HOST['origin']}", f,
                     4 * xb.numel(), lambda: f.bcast(HOST["origin"], xb),
                     lambda: torch_b.bcast(HOST["origin"], xb))
            for what, votes in (("yes", [1] * WS),
                                ("veto", [0 if r == HOST["veto"] else 1
                                          for r in range(WS)])):
                d, ms = _host_wall(dev, lambda: f.consensus(
                    votes, proposer=HOST["proposer"]))
                want = torch_b.consensus(votes)
                check(d == want == (what == "yes"),
                      f"{tag} consensus ({what}): {d}, TorchBackend {want}")
                rows[f"consensus {what}"] = {"ms": ms, "decision": d}
                print(f"[host] {tag} consensus ({what}) from proposer "
                      f"{HOST['proposer']}: decision {d} = TorchBackend's, "
                      f"{ms:.2f} ms")
            _, ms = _host_wall(dev, f.barrier)
            rows["barrier"] = {"ms": ms}
            print(f"[host] {tag} barrier {ms:.2f} ms")
            s = f.sub_group(sub)
            try:
                sxs = [xs_rs[r] for r in sub]
                _host_op(dev, rows, tag, f"sub_group {sub} allreduce f32 "
                         f"sum {alg_f32}", s, 4 * n_rs,
                         lambda: s.allreduce(sxs, algorithm=alg_f32),
                         lambda: sub_b.allreduce(sxs, algorithm="ring"))
                votes = [1, 1, 0, 1]
                d = s.consensus(votes, proposer=1)
                check(d == sub_b.consensus(votes) == 0,
                      f"{tag} sub_group consensus with a veto: {d}")
                _host_op(dev, rows, tag, f"sub_group {sub} bcast from 2",
                         s, 4 * xb.numel(), lambda: s.bcast(2, xb),
                         lambda: sub_b.bcast(2, xb))
            finally:
                s.close()
        finally:
            f.close()
        rows["seconds"] = time.perf_counter() - t0
        stats[tag] = rows
        print(f"[host] {tag} took {rows['seconds']:.1f} s")
        torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t_phase
    return stats


def phase_host_procs(dev, n: int) -> dict:
    """(c) ``init("mpi")`` in HOST_PROCS['procs'] processes under the
    port's femtompirun and (d) ``init("tcp")`` under its tcprun, each
    process one rank holding its tensors on ``dev``
    (``chip_smoke.py --host-worker``): the ring allreduce of ``n`` f32
    a rank, consensus all YES and with a veto, all_gather and a
    2-member sub-group's ring allreduce and veto. Each process prints
    digests of its results; this process makes the same tensors and
    holds every digest against ``TorchBackend``'s result on them
    (ring allreduce, same ring order as the C ring's: equal bits)."""
    import os
    import torch
    from rlo_tpu_torch.backend import TorchBackend
    from rlo_tpu_torch.native import build

    P = HOST_PROCS
    nproc = P["procs"]
    build.build()
    build.build(femtompi=True)
    launchers = {
        "mpi": [str(build.build_tool("femtompirun")), "-n", str(nproc),
                "-r", str(_femto_ring_bytes(n, nproc)), "-t",
                str(int(P["timeout_s"]))],
        "tcp": [sys.executable, str(build.BUILD_DIR.parent / "tcprun"),
                "-n", str(nproc), "-t", str(P["timeout_s"])]}
    xs = _host_inputs(dev, nproc, n, SEED + 1810)
    smalls = _host_inputs(dev, nproc, P["n_small"], SEED + 1820)
    torch_b = TorchBackend(world_size=nproc, device=dev)
    want_ar = [_host_digest(t)
               for t in torch_b.allreduce(xs, algorithm="ring")]
    want_ag = [_host_digest(t) for t in torch_b.all_gather(smalls)]
    sub = list(P["sub"])
    sub_b = TorchBackend(world_size=len(sub), device=dev)
    want_sub = [_host_digest(t) for t in sub_b.allreduce(
        [smalls[r] for r in sub], algorithm="ring")]
    stats = {"n": n}
    for facade, tag in (("mpi", "18c mpi"), ("tcp", "18d tcp")):
        cmd = launchers[facade] + [sys.executable, os.path.abspath(
            __file__), "--host-worker", facade, str(n), str(P["n_small"]),
            dev.type]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=P["timeout_s"] + 30)
        except subprocess.TimeoutExpired:
            check(False, f"{tag}: the launch hung past {P['timeout_s']} s")
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"{tag}: the launch exited "
              f"{proc.returncode}: {proc.stderr.strip()[-3000:]}")
        res = sorted((json.loads(ln.split(" ", 1)[1])
                      for ln in proc.stdout.splitlines()
                      if ln.startswith("HOST-WORKER ")),
                     key=lambda d: d["rank"])
        check([d["rank"] for d in res] == list(range(nproc)),
              f"{tag}: ranks {[d['rank'] for d in res]} reported")
        for d in res:
            r = d["rank"]
            check(d["ws"] == nproc and d["device"] == str(
                xs[r].device), f"{tag} rank {r}: {d['ws']} ranks, "
                f"results on {d['device']}")
            check(d["allreduce"]["digest"] == want_ar[r],
                  f"{tag} rank {r}: ring allreduce differs from "
                  f"TorchBackend's")
            check(d["all_gather"] == want_ag[r],
                  f"{tag} rank {r}: all_gather differs")
            check(d["consensus_yes"] == 1 and d["consensus_veto"] == 0,
                  f"{tag} rank {r}: consensus {d['consensus_yes']}, "
                  f"{d['consensus_veto']}")
            if r in sub:
                i = sub.index(r)
                check(d["sub"] == {"digest": want_sub[i], "veto": 0},
                      f"{tag} rank {r}: sub-group {d['sub']}")
            else:
                check(d["sub"] is None, f"{tag} rank {r} got a sub-group")
        ar = [d["allreduce"] for d in res]
        slow = max(ar, key=lambda a: a["ms"])
        stats[tag] = {"wall_s": wall, "allreduce": slow,
                      "gb_s": 4 * n / (slow["ms"] * 1e-3) / 1e9,
                      "consensus_ms": max(d["consensus_ms"] for d in res)}
        print(f"[host] {tag}: {nproc} processes on one {dev.type} device, "
              f"results equal TorchBackend's; ring allreduce of {4 * n} B a "
              f"rank, slowest rank {slow['ms']:.1f} ms = to host "
              f"{slow['to_host_ms']:.1f} + protocol "
              f"{slow['protocol_ms']:.1f} + to card "
              f"{slow['to_device_ms']:.1f}, "
              f"{stats[tag]['gb_s']:.3f} GB/s a rank; consensus (veto) "
              f"{stats[tag]['consensus_ms']:.2f} ms; launch to exit "
              f"{wall:.1f} s")
    return stats


def _femto_ring_bytes(n: int, nproc: int) -> int:
    """femtompi's per-pair ring: one ring-allreduce chunk (n / nproc f32)
    and its frame header must fit, with room to spare."""
    return max(4 << 20, 2 * (4 * n // nproc) + (1 << 20))


def host_worker(argv) -> int:
    """One rank of ``phase_host_procs``: facade (mpi or tcp), f32
    elements of the allreduce and of the all_gather, device type. Prints
    one HOST-WORKER line of digests and times."""
    facade, n, n_small, devtype = argv[0], int(argv[1]), int(argv[2]), \
        argv[3]
    import torch
    if devtype == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device in a host-facade process",
              file=sys.stderr)
        return 2
    import rlo_tpu_torch
    P = HOST_PROCS
    dev = torch.device(devtype)
    b = rlo_tpu_torch.init(facade)
    rank, ws = b.rank, b.world_size
    x = _host_inputs(dev, ws, n, SEED + 1810)[rank]
    small = _host_inputs(dev, ws, n_small, SEED + 1820)[rank]
    b.barrier()  # every rank up before the clock starts
    y, ms = _host_wall(dev, lambda: b.allreduce(x, algorithm="ring"))
    st = b.last_staging
    out = {"rank": rank, "ws": ws, "device": str(y.device),
           "allreduce": {"digest": _host_digest(y), "ms": ms,
                         "to_host_ms": st["to_host_s"] * 1e3,
                         "protocol_ms": st["protocol_s"] * 1e3,
                         "to_device_ms": st["to_device_s"] * 1e3}}
    del y
    out["consensus_yes"] = b.consensus(1, proposer=P["proposer"])
    out["consensus_veto"], out["consensus_ms"] = _host_wall(
        dev, lambda: b.consensus(0 if rank == P["veto"] else 1,
                            proposer=P["proposer"]))
    g = b.all_gather(small)
    check(g.device == small.device, f"all_gather on {g.device}")
    out["all_gather"] = _host_digest(g)
    s = b.sub_group(P["sub"])
    out["sub"] = None
    if s is not None:
        z = s.allreduce(small, algorithm="ring")
        veto = s.consensus(0 if s.pos == 1 else 1, proposer=0)
        out["sub"] = {"digest": _host_digest(z), "veto": veto}
    b.barrier()
    if s is not None:
        s.close()
    b.barrier()
    b.close()
    # one write (under PIPE_BUF), so the ranks' lines never interleave
    import os
    sys.stdout.flush()
    os.write(1, ("HOST-WORKER " + json.dumps(out) + "\n").encode())
    return 0


# ---------------------------------------------------------------------------
# Phase 19: the developer tools on the card
# ---------------------------------------------------------------------------

#: f32 elements a rank of 19d's instrumented loopback ring (32 MB), and
#: the time limits of the analyzer run and of the hostile-probe process
TOOLS = dict(scope_n=2 ** 23, runner_timeout_s=300.0,
             hostile_timeout_s=300.0)


def phase_static_tools() -> dict:
    """19a: the merged static report on the tree this script runs from;
    0 findings, the four analyzers named, each one's seconds."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "rlo_tpu_torch.tools.runner", "--json",
         "--root", root], cwd=root, capture_output=True, text=True,
        timeout=TOOLS["runner_timeout_s"])
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"19a: the runner exited "
          f"{proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout)
    tools = {t["tool"]: t for t in doc["tools"]}
    check(list(tools) == ["rlo-lint", "rlo-sentinel", "rlo-prover",
                          "rlo-model"], f"19a: analyzers {list(tools)}")
    check(doc["findings"] == [], f"19a: findings {doc['findings'][:5]}")
    secs = {name: t["seconds"] for name, t in tools.items()}
    print(f"[tools] 19a rlo_tpu_torch.tools.runner on {root}: 0 findings; "
          f"seconds {json.dumps(secs)}; {wall:.1f} s with the interpreter")
    return {"tool_seconds": secs, "wall_s": wall}


def phase_moved_bytes(dev, n_full: int) -> dict:
    """19b: every schedule of the byte pinning on ``WS`` ranks of a
    ``LocalMesh`` on ``dev``, ``n_full`` f32 a rank, each rank's axis a
    ``RecordingAxis``: the bytes handed to ``ppermute`` and the calls a
    rank equal the cost model (``pipeline_chunks`` given) and the ledger
    where it has the schedule; results equal an unrecorded run's bit for
    bit."""
    import torch
    from rlo_tpu_torch.observe.ledger import ledger
    from rlo_tpu_torch.ops import device_collectives as dc
    from rlo_tpu_torch.parallel.mesh import LocalMesh
    from rlo_tpu_torch.utils import moved_bytes as mb

    nbytes = 4 * n_full
    xs = _host_inputs(dev, WS, n_full, SEED + 1900)
    flat = LocalMesh((WS,), ("x",), dev)
    tiers = LocalMesh((2, WS // 2), ("dcn", "ici"), dev)
    a2a = [x.view(WS, -1) for x in xs]
    stats = {}

    def run(tag, mesh, names, fn, inputs):
        recs = [None] * mesh.world_size

        def rank(axes, x, r):
            recs[r] = mb.recording_axes(axes, names)
            return fn(recs[r], x)
        got, ms = _host_wall(dev, lambda: mesh.run(
            rank, inputs, list(range(mesh.world_size))))
        want = mesh.run(lambda axes, x: fn(axes, x), inputs)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"19b {tag}: the recorded run's results differ from an "
              f"unrecorded run's")
        del got, want
        return recs, ms

    for alg, q, sched in (("ring", 1, "ring_allreduce"),
                          ("bidir_ring", 1, None), ("bidir_ring", 2, None),
                          ("bidir_ring", 4, None),
                          ("halving_doubling", 1, "halving_doubling"),
                          ("recursive_doubling", 1, "recursive_doubling")):
        tag = f"{alg} q{q}" if alg == "bidir_ring" else alg
        recs, ms = run(tag, flat, ("x",), lambda ax, x, alg=alg, q=q:
                       dc.allreduce(x, ax["x"], algorithm=alg,
                                    pipeline_chunks=q), xs)
        model = dc.allreduce_cost(alg, WS, nbytes, pipeline_chunks=q)
        want = (model["total_bytes"], model["n_permutes"])
        moved = [mb.permute_total_bytes(r["x"], require=True) for r in recs]
        check(all(m == want for m in moved), f"19b {tag}: moved "
              f"{moved}, the cost model {want}")
        if sched is not None:
            led = ledger(sched, WS, nbytes)
            check((led.bytes_per_rank, led.num_steps) == want,
                  f"19b {tag}: the ledger {led.bytes_per_rank} B in "
                  f"{led.num_steps} steps, the cost model {want}")
        stats[tag] = {"bytes_a_rank": want[0], "ppermutes": want[1],
                      "ms": ms}
        print(f"[tools] 19b {tag}: {want[0]} B in {want[1]} ppermutes a "
              f"rank = the cost model" + (" = the ledger" if sched else "")
              + f"; recorded run {ms:.1f} ms wall, bits equal an "
              f"unrecorded run's")

    wi = WS // 2
    recs, ms = run("hierarchical int8", tiers, ("dcn", "ici"),
                   lambda ax, x: dc.hierarchical_allreduce(
                       x, ax["ici"], ax["dcn"], dcn_algorithm="int8"), xs)
    model = dc.hierarchical_allreduce_cost(wi, 2, nbytes,
                                           dcn_algorithm="int8")
    led = ledger("halving_doubling", wi, nbytes)
    for r in recs:
        ici = mb.permute_total_bytes(r["ici"], require=True)
        check(ici == (model["ici_bytes"], model["ici_permutes"]) ==
              (led.bytes_per_rank, led.num_steps),
              f"19b hierarchical: ici moved {ici}, the cost model "
              f"{model['ici_bytes'], model['ici_permutes']}")
        payload = [e for e, dt in mb.all_gather_operands(r["dcn"],
                                                         require=True)
                   if dt == "i8"]
        check(payload == [model["dcn_elems"]], f"19b hierarchical: int8 "
              f"payload {payload}, the cost model {model['dcn_elems']}")
    stats["hierarchical int8"] = {"ici_bytes": model["ici_bytes"],
                                  "ici_permutes": model["ici_permutes"],
                                  "dcn_int8_elems": model["dcn_elems"],
                                  "ms": ms}
    print(f"[tools] 19b hierarchical {wi} x 2, int8 over the outer axis: "
          f"{model['ici_bytes']} B in {model['ici_permutes']} ppermutes "
          f"a rank on the inner axis = the cost model = the ledger, "
          f"{model['dcn_elems']} int8 elements gathered over the outer; "
          f"recorded run {ms:.1f} ms wall, bits equal an unrecorded run's")

    recs, ms = run("all_to_all direct", flat, ("x",),
                   lambda ax, x: dc.all_to_all(x, ax["x"],
                                               algorithm="direct"), a2a)
    model = dc.all_to_all_cost("direct", WS, nbytes)
    want = (model["injected_bytes"], model["link_hop_bytes"],
            model["n_permutes"])
    for r in recs:
        ent = mb.permute_entries(r["x"], require=True)
        got = (sum(b for _s, _d, b in ent),
               sum((d - s) % WS * b for s, d, b in ent), len(ent))
        check(got == want, f"19b all_to_all: moved {got}, the cost "
              f"model {want}")
    stats["all_to_all direct"] = {"injected_bytes": want[0],
                                  "link_hop_bytes": want[1],
                                  "ppermutes": want[2], "ms": ms}
    print(f"[tools] 19b all_to_all direct: {want[0]} B injected, "
          f"{want[1]} B x hops in {want[2]} ppermutes a rank = the cost "
          f"model; recorded run {ms:.1f} ms wall, bits equal an "
          f"unrecorded run's")
    del xs, a2a
    return stats


def _hostile_mask(shape, written) -> "torch.Tensor":
    """A bool mask of ``shape``, True at the index tuples ``written``
    (a leading slice stands for a whole axis)."""
    import torch
    m = torch.zeros(shape, dtype=torch.bool)
    for idx in written:
        m[idx] = True
    return m


def hostile_probes(dev) -> dict:
    """19c: K6-K11 at rlo-prover P3's probe shapes with hostile values,
    each against its plain twin on the same inputs: attention (K6, K9)
    within phase 4's tolerance (NaN where no position is attended, on
    both sides), writes (K7, K8, K10, K11) bit for bit; every element a
    write must leave (dropped rows, lanes outside the page, pads) equal
    to what it was."""
    import torch
    from rlo_tpu_torch.kernels import build
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.serving.pages import NULL_PAGE

    build.load("decode")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1930)
    big, small = 2 ** 31 - 1, -2 ** 31
    out = {}

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def attend(tag, fn, plain, q, *args, want_launches=1):
        before = fn.launches
        got = fn(q, *args)
        torch.cuda.synchronize()
        check(fn.launches - before == want_launches,
              f"19c {tag}: {fn.launches - before} launches")
        want = plain(q, *args)
        check(torch.equal(got.isnan(), want.isnan()),
              f"19c {tag}: NaN where its plain twin has none, or not")
        err = abs_err(got.nan_to_num(), want.nan_to_num())
        check(torch.allclose(got, want, rtol=1e-3, atol=2e-3,
                             equal_nan=True), f"19c {tag}: differs from "
              f"its plain twin by {err}")
        out[tag] = {"max_abs_err": err,
                    "nan_rows": int(got.isnan().any(-1).sum())}

    def write(tag, fn, plain, dst, rest, written):
        orig = dst.clone()
        got = fn(dst.clone(), *rest)
        torch.cuda.synchronize()
        want = plain(orig.clone(), *rest)
        check(torch.equal(got, want), f"19c {tag}: differs from its plain "
              f"twin")
        keep = ~_hostile_mask(tuple(dst.shape), written).to(dev)
        check(torch.equal(got[keep], orig[keep]), f"19c {tag}: an element "
              f"a dropped row or lane holds was written")
        out[tag] = {"written": int((got != orig).sum()),
                    "untouched": int(keep.sum())}

    bf = torch.bfloat16
    for dt in (bf, torch.float32):
        k = torch.randn(2, 4, 64, 1024, generator=gen, device=dev).to(dt)
        v = torch.randn(2, 4, 64, 1024, generator=gen, device=dev).to(dt)
        q = torch.randn(2, 2, 8, 64, generator=gen, device=dev).to(bf)
        for pos in ([0, 800], [-5, 1030], [small, big], [-1, 1023]):
            attend(f"K6 {str(dt)[6:]} pos {pos}", kd.flash_block_decode,
                   kd.flash_block_decode_plain, q, k, v, i32(pos), 0.125)
    kp = torch.randn(8, 4, 64, 128, generator=gen, device=dev).to(bf)
    vp = torch.randn(8, 4, 64, 128, generator=gen, device=dev).to(bf)
    q = torch.randn(2, 2, 8, 64, generator=gen, device=dev).to(bf)
    for table, pos in (([[0, 1, 7], [2, 300, NULL_PAGE]], [5, 383]),
                       ([[-4, big, 3], [NULL_PAGE, small, 6]], [-7, big]),
                       ([[NULL_PAGE] * 3, [5, 5, 5]], [200, 1000])):
        attend(f"K9 table {table} pos {pos}", kd.paged_flash_decode,
               kd.paged_flash_decode_plain, q, kp, vp, i32(table),
               i32(pos), 0.125)

    cache = torch.randn(4, 4, 64, 1024, generator=gen, device=dev).to(bf)
    row = torch.randn(4, 4, 64, generator=gen, device=dev).to(bf)
    for pos in ([0, 5, 1023, 2048], [big, small, -1, 1024]):
        written = [(b, slice(None), slice(None), p)
                   for b, p in enumerate(pos) if 0 <= p < 1024]
        write(f"K7 pos {pos}", kd.write_kv_row, kd.write_kv_row_plain,
              cache, (row, i32(pos)), written)
    rows = torch.randn(4, 4, 64, 8, generator=gen, device=dev).to(bf)
    for pos in ([0, 100, 900, 1016], [-3, 1020, big - 4, small]):
        written = [(b, slice(None), slice(None), c) for b, p in
                   enumerate(pos) for c in range(p, p + 8)
                   if 0 <= c < 1024]
        write(f"K8 pos0 {pos}", kd.write_kv_block, kd.write_kv_block_plain,
              cache, (rows, i32(pos)), written)
    pool = torch.randn(16, 4, 64, 128, generator=gen, device=dev).to(bf)
    for page, off in (([1, 3, 15, 200], [0, 64, 127, 128]),
                      ([-5, NULL_PAGE, big, 7], [3, -1, 5, big])):
        written = [(min(max(p, 0), 15), slice(None), slice(None), o)
                   for p, o in zip(page, off) if 0 <= o < 128]
        write(f"K10 page {page} off {off}", kd.write_kv_page_row,
              kd.write_kv_page_row_plain, pool, (row, i32(page), i32(off)),
              written)
    chunk = torch.randn(4, 64, 16, generator=gen, device=dev).to(bf)
    for page, off0, n_valid in ((200, 64, 16), (-3, 120, 16),
                                (NULL_PAGE, -5, 16), (big, 0, -1),
                                (small, 100, 1000)):
        written = [(min(max(page, 0), 15), slice(None), slice(None), c)
                   for t, c in enumerate(range(off0, off0 + 16))
                   if t < n_valid and 0 <= c < 128]
        write(f"K11 page {page} off0 {off0} n_valid {n_valid}",
              kd.write_kv_page_block, kd.write_kv_page_block_plain, pool,
              (chunk, page, off0, n_valid), written)
    return out


def hostile_worker() -> int:
    """``chip_smoke.py --hostile-worker``: one CUDA call first (so a
    sanitizer that cannot run a CUDA program shows as a missing
    ``HOSTILE-CUDA-UP`` line), then ``hostile_probes``; prints one
    ``HOSTILE`` line of its figures."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device in the hostile-probe process",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    check(float((torch.ones(4, device=dev) + 1).sum()) == 8.0,
          "a first CUDA call")
    print("HOSTILE-CUDA-UP", flush=True)
    print("HOSTILE " + json.dumps(hostile_probes(dev)), flush=True)
    return 0


def phase_hostile() -> dict:
    """19c: ``hostile_worker`` in a process of its own, under
    ``compute-sanitizer --tool memcheck`` beside ``nvcc`` when that can
    run a CUDA program (a memcheck error fails the phase), else bare,
    saying why."""
    import os
    from pathlib import Path
    from rlo_tpu_torch.kernels import build
    me = [sys.executable, os.path.abspath(__file__), "--hostile-worker"]
    sanitizer = Path(build.find_nvcc()).with_name("compute-sanitizer")
    how, why = "bare", "no compute-sanitizer beside nvcc"
    t0 = time.perf_counter()
    proc = None
    if sanitizer.is_file():
        proc = subprocess.run(
            [str(sanitizer), "--tool", "memcheck", "--error-exitcode", "9"]
            + me, capture_output=True, text=True,
            timeout=TOOLS["hostile_timeout_s"])
        if "HOSTILE-CUDA-UP" in proc.stdout:
            how = "compute-sanitizer --tool memcheck"
            check(proc.returncode == 0 and
                  "ERROR SUMMARY: 0 errors" in proc.stdout + proc.stderr,
                  f"19c: memcheck found errors: {proc.stdout[-3000:]} "
                  f"{proc.stderr[-3000:]}")
        else:
            tail = [ln for ln in (proc.stderr + proc.stdout).splitlines()
                    if "error" in ln.lower()][:2]
            why = (f"{sanitizer} cannot run a CUDA program on this machine "
                   f"(exit {proc.returncode}: {' | '.join(tail)})")
            proc = None
    if proc is None:
        proc = subprocess.run(me, capture_output=True, text=True,
                              timeout=TOOLS["hostile_timeout_s"])
        check(proc.returncode == 0, f"19c: the hostile probes exited "
              f"{proc.returncode}: {proc.stderr[-3000:]}")
    wall = time.perf_counter() - t0
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("HOSTILE ")]
    check(len(line) == 1, f"19c: no figures: {proc.stdout[-2000:]}")
    cases = json.loads(line[0].split(" ", 1)[1])
    print(f"[tools] 19c K6-K11 at P3's probe shapes with hostile "
          f"positions, page ids and the null page: {len(cases)} cases, "
          f"each equal to its plain twin, dropped rows untouched; run "
          f"{how}" + ("" if how != "bare" else f" ({why})")
          + f"; {wall:.1f} s")
    return {"cases": cases, "run": how, "why_bare": why if how == "bare"
            else None, "wall_s": wall}


def phase_scope_trace(dev, span_dir, victim: int) -> dict:
    """19d: (1) a ring allreduce through ``init("loopback")`` with every
    rank's ``Comm`` instrumented (``Comm.instrument``), fed
    ``TOOLS['scope_n']`` f32 card tensors a rank and held against
    ``TorchBackend``; the tracer's per-rank JSON-line dumps through
    rlo-scope's dump mode: no predicted-vs-measured finding, each step's
    GB/s. (2) rlo-trace over phase 17's span dumps in ``span_dir``: no
    inconsistent trace, and every incomplete one (no ``deliver`` span) a
    request whose gateway was the killed rank ``victim``, which died
    before it could deliver: every other request traced to delivery."""
    import contextlib
    import io
    import os
    import re
    import rlo_tpu_torch
    from rlo_tpu_torch.backend import TorchBackend
    from rlo_tpu_torch.tools import rlo_scope, rlo_trace
    from rlo_tpu_torch.utils.tracing import Tracer

    def tool(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        return rc, json.loads(buf.getvalue())

    n = TOOLS["scope_n"]
    xs = _host_inputs(dev, WS, n, SEED + 1940)
    tracer = Tracer(capacity=1 << 20, enabled=True)
    f = rlo_tpu_torch.init("loopback", world_size=WS)
    try:
        for c in f._comms:
            c.instrument(time.monotonic, tracer)
        got, ms = _host_wall(dev, lambda: f.allreduce(xs,
                                                      algorithm="ring"))
    finally:
        f.close()
    _held("19d loopback ring", got,
          TorchBackend(world_size=WS, device=dev).allreduce(
              xs, algorithm="ring"))
    del got
    dumps = [os.path.join(span_dir, f"steps.rank{r}.jsonl")
             for r in range(WS)]
    for r, p in enumerate(dumps):
        tracer.dump_jsonl(p, rank=r)
    rc, doc = tool(rlo_scope.main, dumps + ["--nbytes", str(4 * n),
                                            "--json"])
    check(rc == 0 and doc["findings"] == [],
          f"19d rlo-scope: exit {rc}, findings {doc['findings']}")
    check(doc["schedule"] == "ring_allreduce" and doc["n"] == WS,
          f"19d rlo-scope joined {doc['schedule']} over {doc['n']} ranks")
    gbps = {f"{s['algorithm']}:{s['step']}": s["gbps_med"]
            for s in doc["steps"]}
    print(f"[tools] 19d rlo-scope over {WS} per-rank dumps of the "
          f"instrumented loopback ring allreduce ({4 * n} B a rank, "
          f"{ms:.1f} ms wall with staging, results equal TorchBackend's): "
          f"{doc['ledger']['steps']} ledger steps, "
          f"{doc['measured']['step_events']} step events, no finding; "
          f"median GB/s a step {json.dumps(gbps)}")
    spans = sorted(os.path.join(span_dir, p) for p in os.listdir(span_dir)
                   if p.startswith("spans."))
    check(len(spans) == FABRIC["ranks"], f"19d: span dumps {spans}")
    rc, trace = tool(rlo_trace.main, spans + ["--json"])
    undelivered = []
    for fnd in trace["findings"]:
        m = re.fullmatch(r"request (\d+):(\d+) has spans but never "
                         r"delivered \(incomplete trace\)", fnd["message"])
        check(fnd["rule"] == "T1" and m is not None and
              int(m.group(1)) == victim,
              f"19d rlo-trace: {fnd['rule']} {fnd['message']}")
        undelivered.append(f"{m.group(1)}:{m.group(2)}")
    check(rc == (1 if undelivered else 0), f"19d rlo-trace: exit {rc}")
    check(trace["requests"] == FABRIC["requests"] and
          trace["complete"] == trace["requests"] - len(undelivered),
          f"19d rlo-trace: {trace['complete']} of {trace['requests']} "
          f"requests delivered, {len(undelivered)} undelivered")
    print(f"[tools] 19d rlo-trace over phase 17's span dumps: "
          f"{trace['complete']} of {trace['requests']} requests traced to "
          f"delivery; the {len(undelivered)} incomplete traces "
          f"{undelivered} are all requests of gateway {victim}, the rank "
          f"killed before it delivered them; failover on the critical "
          f"path {trace['failover']}; virtual e2e p50/p99 "
          f"{trace['e2e_usec']['p50']}/{trace['e2e_usec']['p99']} us")
    return {"scope_gbps": gbps, "scope_wall_ms": ms,
            "trace_requests": trace["requests"],
            "trace_undelivered": undelivered,
            "trace_failover": trace["failover"]}


def phase_tools(dev, n_full: int, span_dir, victim: int) -> dict:
    """Phase 19 (see the module docstring): 19a-19d, each timed. K1's
    launch count is set to 0 just before 19b and read just after it."""
    import torch
    from rlo_tpu_torch.kernels import reduce as k1
    out = {}
    for tag, fn in (("19a", phase_static_tools),
                    ("19b", lambda: phase_moved_bytes(dev, n_full)),
                    ("19c", phase_hostile),
                    ("19d", lambda: phase_scope_trace(dev, span_dir,
                                                      victim))):
        k1.fused_combine.launches = 0
        t0 = time.perf_counter()
        out[tag] = fn()
        out[tag]["seconds"] = time.perf_counter() - t0
        if tag == "19b":
            out["k1_launches_19b"] = k1.fused_combine.launches
        print(f"[tools] {tag} took {out[tag]['seconds']:.1f} s")
        torch.cuda.empty_cache()
    check(out["k1_launches_19b"] > 0, "K1 was not launched by the byte "
          "pinning's schedules (phase 19b)")
    return out


# ---------------------------------------------------------------------------
# Phase 20: the collectives' backward: K1 with a backward, the
# differentiable schedules as processes, forward's gradient under a manual
# tp schedule
# ---------------------------------------------------------------------------

#: 20a's operand sizes: 32 MB a tensor (8 Mi f32, 16 Mi bf16 elements)
#: and a ragged count
GRAD_K1 = dict(nbytes=32 * 2 ** 20, ragged=1_000_003)
#: phase 20's processes (ranks over gloo on the one card), its time limit,
#: 20b's payload a rank (1 MB of f32) and bcast origin, the forward and
#: backward runs 20c times a schedule
GRAD_PARALLEL = dict(procs=4, timeout_s=300.0, n=2 ** 18, origin=2, reps=2)
#: 20c's manual tp schedules
GRAD_TP_ALGORITHMS = ("ring", "bidir_ring", "recursive_doubling",
                      "halving_doubling")


def phase_k1_grad(dev) -> dict:
    """20a: ``FusedCombine`` (K1 out of place, with a backward) against
    its plain path (``FusedCombine.apply(..., use_kernel=False)``: the
    plain forward, JAX's min/max rule backward) on the same card tensors:
    f32/bf16 x sum/min/max at 32 MB and at a ragged size, integer-valued
    operands (ties everywhere) with NaNs in both. The forward's bits and
    both gradients' must be the plain path's, the forward one K1 launch
    and the backward none, and where a NaN won min/max neither operand
    gets a share. Then the forward and backward at 32 MB f32 max against
    the plain path's, by events."""
    import torch
    from rlo_tpu_torch.kernels import reduce as k1

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)

    def operands(n, dtype):
        a, b = (torch.randint(-8, 9, (n,), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        a[::1009] = float("nan")
        b[5::997] = float("nan")
        ct = torch.randn(n, generator=gen, device=dev).to(dtype)
        return a, b, ct

    def grads(fn, a, b, ct, op):
        la, lb = a.clone().requires_grad_(), b.clone().requires_grad_()
        y = fn(la, lb, op)
        return (y,) + torch.autograd.grad(y, (la, lb), ct)

    def plain(a, b, op):
        return k1.FusedCombine.apply(a, b, op, False)

    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        esize = torch.empty((), dtype=dtype).element_size()
        for n in (GRAD_K1["nbytes"] // esize, GRAD_K1["ragged"]):
            for op in ("sum", "min", "max"):
                a, b, ct = operands(n, dtype)
                before = k1.fused_combine.launches
                got = grads(k1.FusedCombine.apply, a, b, ct, op)
                torch.cuda.synchronize()
                check(k1.fused_combine.launches == before + 1,
                      f"FusedCombine {op} {dtype} n={n} launched K1 "
                      f"{k1.fused_combine.launches - before} times, not once")
                want = grads(plain, a, b, ct, op)
                torch.cuda.synchronize()
                for what, g, w in zip(("forward", "grad a", "grad b"), got,
                                      want):
                    check(same_bits(g.detach(), w.detach()),
                          f"FusedCombine {op} {dtype} n={n}: {what} is not "
                          f"bit-identical to the plain path's")
                if op != "sum":
                    nan = a.isnan() | b.isnan()
                    check(all(bool((g[nan] == 0).all()) for g in got[1:]),
                          f"FusedCombine {op} {dtype} n={n}: a winning NaN "
                          f"passed the cotangent on (JAX gives no share)")
                cases += 1
    a, b, ct = operands(GRAD_K1["nbytes"] // 4, torch.float32)
    ms = time_ms(lambda: grads(k1.FusedCombine.apply, a, b, ct, "max"),
                 iters=10)
    plain_ms = time_ms(lambda: grads(plain, a, b, ct, "max"), iters=10)
    print(f"[k1-grad] 20a {cases} cases (f32/bf16 x sum/min/max x 32 MB and "
          f"{GRAD_K1['ragged']} elements, integer-valued operands with ties "
          f"and NaNs): FusedCombine's forward one K1 launch and bit-identical "
          f"to fused_combine_plain, both gradients bit-identical to the "
          f"plain path's (JAX's rule: no share to either where a NaN "
          f"won); forward + backward at 32 MB f32 max {ms:.4f} ms, the "
          f"plain path's {plain_ms:.4f} ms (events)")
    return {"cases": cases, "fwd_bwd_ms_32MB_max": ms,
            "plain_fwd_bwd_ms_32MB_max": plain_ms}


def _combines(kind: str, alg: str, ws: int, nq: int) -> int:
    """K1 launches a rank makes in one forward of a schedule at ``ws``
    (bidir ring: ``nq`` sub-chunks a row; hierarchical: ``alg`` is the
    dcn step on a 2 x 2 mesh)."""
    k = ws.bit_length() - 1
    if kind == "allreduce":
        return {"ring": ws - 1, "bidir_ring": 2 * (ws - 1) * nq,
                "recursive_doubling": k, "halving_doubling": k}[alg]
    if kind == "reduce_scatter":
        return ws - 1 if alg == "ring" else k
    if kind == "hierarchical":
        return 1 + (alg == "ring")
    return 0


def _grad_cases(n, origin):
    """20b's matrix: (tag, kind, algorithm, op, mesh)."""
    cases = [(f"allreduce {alg} {op}", "allreduce", alg, op, "x")
             for alg in GRAD_TP_ALGORITHMS for op in ("sum", "max")]
    cases += [(f"reduce_scatter {alg}", "reduce_scatter", alg, "sum", "x")
              for alg in ("ring", "halving")]
    cases += [(f"all_gather {alg}", "all_gather", alg, "sum", "x")
              for alg in ("xla", "ring", "doubling")]
    cases += [(f"rootless_bcast {s} from {origin}", "bcast", s, "sum", "x")
              for s in ("binomial", "skip_ring", "gather")]
    cases += [(f"hierarchical 2 x 2 {alg}", "hierarchical", alg, "sum",
               "dcn x ici") for alg in ("psum", "ring")]
    return cases


def _grad_collectives(axes, mesh2, rank, ws, n, origin, dev, sync) -> list:
    """20b in one process: every case's gradient against its closed form,
    from every rank's inputs and cotangents (made in each process from
    the same seed: integer-valued, so every sum is exact; the max inputs a
    permutation of 0..ws-1 along the ranks, so one rank wins each
    element)."""
    import torch
    from rlo_tpu_torch.kernels import reduce as k1
    from rlo_tpu_torch.ops import device_collectives as dc

    nq = dc._default_pipeline_chunks(dev)
    # the first pass warms what a process does first (gloo's first
    # exchanges on a group, the first backward, each kernel's first
    # launch: seconds in all); the second pass is the one reported
    passes = []
    for _ in range(2):
        gen = torch.Generator(device=dev).manual_seed(SEED + 21)
        xs = torch.randint(-8, 9, (ws, n), generator=gen, device=dev).float()
        perm = torch.rand((ws, n), generator=gen,
                          device=dev).argsort(0).float()
        out = []
        for tag, kind, alg, op, mesh in _grad_cases(n, origin):
            x = (perm if op == "max" else xs)[rank]
            if kind == "allreduce":
                shape = (n,)

                def fn(v, alg=alg, op=op):
                    return dc.allreduce(v, axes["x"], op=op, algorithm=alg)
            elif kind == "reduce_scatter":
                shape = (n // ws,)

                def fn(v, alg=alg):
                    return dc.reduce_scatter(v, axes["x"], algorithm=alg)
            elif kind == "all_gather":
                shape = (ws, n)

                def fn(v, alg=alg):
                    return dc.all_gather(v, axes["x"], algorithm=alg)
            elif kind == "bcast":
                shape = (n,)

                def fn(v, alg=alg):
                    return dc.rootless_bcast(v, origin, axes["x"],
                                             schedule=alg)
            else:
                shape = (n,)

                def fn(v, alg=alg):
                    return dc.hierarchical_allreduce(v, mesh2["ici"],
                                                     mesh2["dcn"],
                                                     dcn_algorithm=alg)
            cts = torch.randint(-8, 9, (ws,) + shape, generator=gen,
                                device=dev).float()
            if kind in ("allreduce", "bcast") or alg == "ring" and \
                    kind == "hierarchical":
                want = cts.sum(0)
                if op == "max":
                    want = torch.where(perm[rank] == ws - 1, want, 0.0)
                if kind == "bcast" and rank != origin:
                    want = torch.zeros_like(want)
            elif kind == "reduce_scatter":
                want = cts.reshape(-1)[:n]
            elif kind == "all_gather":
                want = cts.sum(0)[rank]
            else:   # psum over dcn: the result is invariant over dcn
                row = rank // 2 * 2
                want = cts[row] + cts[row + 1]
            staged0 = sum(a.staged_bytes for a in (axes["x"], mesh2["ici"],
                                                   mesh2["dcn"]))
            sync()
            t0 = time.perf_counter()
            v = x.clone().requires_grad_(True)
            k1.fused_combine.launches = 0
            y = fn(v)
            fwd = k1.fused_combine.launches
            (g,) = torch.autograd.grad(y, v, cts[rank])
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            out.append(dict(
                tag=tag, equal=bool(torch.equal(g, want)),
                max_abs_err=float((g - want).abs().max()), ms=ms,
                k1_forward=fwd, k1_backward=k1.fused_combine.launches - fwd,
                k1_want=_combines(
                    kind, alg, 2 if kind == "hierarchical" else ws, nq),
                staged_bytes=sum(a.staged_bytes for a in (
                    axes["x"], mesh2["ici"], mesh2["dcn"])) - staged0))
        passes.append(out)
    for first, last in zip(*passes):   # both passes held
        last["equal"] = first["equal"] and last["equal"]
    return passes[-1]


def _grad_parallel_plan(dev, tmp) -> dict:
    """The single-card gradient of 20c's objective, sum(logits * c), on
    the flagship config at phase 9's global batch (c a fixed random
    cotangent from the seed), times the tp size, saved on the host per
    leaf; and the plan the worker processes read."""
    import os
    import torch
    from rlo_tpu_torch.models import transformer as tt

    cfg = tt.TransformerConfig(**SERVE_CFG)
    params = tt.init_params(cfg, seed=SEED, device=dev)
    leaves = [t.requires_grad_(True) for t in tt.tree_leaves(params)]
    tokens, cot = _grad_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
    for _ in range(2):      # the second run timed, warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = tt.forward(params, tokens, cfg)
        grads = torch.autograd.grad((logits * cot).sum(), leaves)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    tp = GRAD_PARALLEL["procs"]
    path = os.path.join(tmp, "ref_grads.pt")
    torch.save([(tp * g).cpu() for g in grads], path)
    del params, leaves, logits, grads, tokens, cot
    torch.cuda.empty_cache()
    return {"n": GRAD_PARALLEL["n"], "origin": GRAD_PARALLEL["origin"],
            "reps": GRAD_PARALLEL["reps"], "cfg": dict(SERVE_CFG),
            "algorithms": list(GRAD_TP_ALGORITHMS), "ref": path,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "single_card_ms": wall, "count_plain": dev.type == "cpu"}


def _grad_batch(cfg, batch, seq, dev):
    """20c's tokens (phase 16's: phase 9's global batch) and cotangent."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    cot = torch.randn((batch, seq, cfg.vocab), generator=gen, device=dev)
    return tokens, cot


def grad_parallel_worker(argv) -> int:
    """One process of phase 20: rank, world size, store path, device
    type, plan path. Runs 20b and then 20c as one rank over gloo on
    ``dist_mesh_axes`` and prints a ``GRAD-PARALLEL`` JSON line for each
    20b case list and each 20c schedule."""
    rank, ws, store, devtype, plan_path = (int(argv[0]), int(argv[1]),
                                           argv[2], argv[3], argv[4])
    import torch
    if devtype == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device in a phase-20 process",
              file=sys.stderr)
        return 2
    from datetime import timedelta

    import torch.distributed as dist
    from rlo_tpu_torch.kernels import flash as kf
    from rlo_tpu_torch.kernels import reduce as k1
    from rlo_tpu_torch.models import transformer as tt
    from rlo_tpu_torch.parallel.mesh import dist_mesh_axes
    from rlo_tpu_torch.parallel.sharding import leaf_specs, shard_tree

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    with open(plan_path) as f:
        plan = json.load(f)
    counted = (k1.fused_combine, kf.flash_block_update_hld, kf.bwd_dq,
               kf.bwd_dkv)
    if plan["count_plain"]:
        # a rehearsal on the CPU: the plain versions count in their
        # wrappers' place
        for mod, wrapper in zip((k1,) + (kf,) * 3, counted):
            def bump(*a, _orig=getattr(mod, wrapper.__name__ + "_plain"),
                     _w=wrapper, **kw):
                _w.launches += 1
                return _orig(*a, **kw)
            setattr(mod, wrapper.__name__ + "_plain", bump)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if devtype == "cuda" else torch.device("cpu")
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, ws), rank=rank, world_size=ws,
        timeout=timedelta(seconds=GRAD_PARALLEL["timeout_s"] / 2))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    try:
        axes = dist_mesh_axes((ws,), ("x",), device=dev)
        mesh2 = dist_mesh_axes((2, ws // 2), ("dcn", "ici"), device=dev)
        cases = _grad_collectives(axes, mesh2, rank, ws, plan["n"],
                                  plan["origin"], dev, sync)
        print("GRAD-PARALLEL " + json.dumps(dict(kind="20b", rank=rank,
                                                 cases=cases)), flush=True)
        cfg = tt.TransformerConfig(**plan["cfg"])
        specs = tt.param_pspecs(cfg, "tp")
        tp = {"tp": axes["x"]}
        params = shard_tree(tt.init_params(cfg, seed=SEED, device=dev),
                            specs, tp)
        leaves = [t.requires_grad_(True) for t in tt.tree_leaves(params)]
        tokens, cot = _grad_batch(cfg, plan["batch"], plan["seq"], dev)
        ref = shard_tree(tt._rebuild(params, iter(torch.load(
            plan["ref"], mmap=True))), specs, tp)
        for alg in plan["algorithms"]:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            walls = []
            for i in range(plan["reps"]):
                staged0 = axes["x"].staged_bytes
                for fn in counted:
                    fn.launches = 0
                sync()
                t0 = time.perf_counter()
                logits = tt.forward(params, tokens, cfg, tp_axis=axes["x"],
                                    tp_algorithm=alg)
                k1_fwd = k1.fused_combine.launches
                grads = torch.autograd.grad((logits * cot).sum(), leaves)
                sync()
                walls.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    first = grads
                    launches = {fn.__name__: fn.launches for fn in counted}
                    launches["fused_combine_forward"] = k1_fwd
                    staged = axes["x"].staged_bytes - staged0
                del logits, grads
            peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
                if dev.type == "cuda" else 0.0
            held = []
            for g, r, spec in zip(first, tt.tree_leaves(ref),
                                  leaf_specs(params, specs)):
                r = r.to(dev).double()
                held.append(dict(
                    key=[axes["x"].index for a in spec if a is not None],
                    diff=float((g.double() - r).square().sum()),
                    ref=float(r.square().sum()), digest=_digest(g)))
            print("GRAD-PARALLEL " + json.dumps(dict(
                kind="20c", tag=alg, rank=rank, walls=walls, peak_gib=peak,
                staged_bytes=staged, launches=launches, leaves=held)),
                flush=True)
            del first, held
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def phase_grad_parallel(dev) -> dict:
    """Phase 20 (see the module docstring): 20a here, then 20b and 20c in
    ``GRAD_PARALLEL['procs']`` processes ``chip_smoke.py
    --grad-parallel-worker`` over gloo on the one card (a backward
    collective needs each rank's backward on a thread of its own), their
    tensors and kernels on the card, their collectives through host
    buffers."""
    import torch

    stats = {"20a": phase_k1_grad(dev)}
    torch.cuda.empty_cache()
    nproc = GRAD_PARALLEL["procs"]
    plan, lines, t_ref, t_procs = _rank_processes(
        dev, _grad_parallel_plan, "--grad-parallel-worker", nproc,
        GRAD_PARALLEL["timeout_s"], 20, "GRAD-PARALLEL")
    # 20b: every case's gradient equals its closed form on every process
    got = sorted((x for x in lines if x["kind"] == "20b"),
                 key=lambda x: x["rank"])
    check(len(got) == nproc, f"20b: {len(got)} of {nproc} processes "
                             f"reported")
    b = {}
    for i, case in enumerate(got[0]["cases"]):
        per = [x["cases"][i] for x in got]
        tag = case["tag"]
        for c in per:
            check(c["equal"], f"20b {tag}: a process's gradient differs "
                              f"from the closed form (max |err| "
                              f"{c['max_abs_err']})")
            check(c["k1_forward"] == c["k1_want"] and c["k1_backward"] == 0,
                  f"20b {tag}: K1 launched {c['k1_forward']} times in the "
                  f"forward (counted {c['k1_want']}) and "
                  f"{c['k1_backward']} in the backward")
        b[tag] = dict(ms_max=max(c["ms"] for c in per),
                      staged_bytes=max(c["staged_bytes"] for c in per),
                      k1_forward=case["k1_forward"])
    print(f"[grad-parallel] 20b {len(b)} cases on {nproc} processes, "
          f"{GRAD_PARALLEL['n'] * 4 >> 20} MB f32 a rank, integer-valued: "
          f"every process's gradient equals its closed form; K1 launches "
          f"a forward as counted, none in a backward; forward + backward "
          f"ms (slowest process) / bytes staged a process: " + "; ".join(
              f"{t} {s['ms_max']:.1f} / {s['staged_bytes']}"
              for t, s in b.items()))
    stats["20b"] = b
    # 20c: forward's gradient under each manual tp schedule at tp 4
    cfg = plan["cfg"]
    nq = 2 if dev.type == "cuda" else 1
    for alg in plan["algorithms"]:
        tag = f"20c tp {nproc} {alg}"
        got = sorted((x for x in lines if x["kind"] == "20c"
                      and x["tag"] == alg), key=lambda x: x["rank"])
        check(len(got) == nproc, f"{tag}: {len(got)} of {nproc} processes "
                                 f"reported")
        rel, copies = _leaf_slices(got, tag)
        check(max(rel) <= DP_REL_LIMIT,
              f"{tag}: gradient differs from {nproc} x the single card's: "
              f"max relative L2 {max(rel):.3g} > {DP_REL_LIMIT}")
        k1_want = cfg["n_layers"] * 2 * _combines("allreduce", alg, nproc,
                                                  nq)
        for x in got:
            n = x["launches"]
            check(n["fused_combine_forward"] == n["fused_combine"] == k1_want,
                  f"{tag}: process {x['rank']} launched K1 "
                  f"{n['fused_combine_forward']} times in the forward and "
                  f"{n['fused_combine']} in all, not {k1_want} (layers x 2 "
                  f"sums x the schedule's combines)")
            check(all(n[k] == cfg["n_layers"] for k in (
                "flash_block_update_hld", "bwd_dq", "bwd_dkv")),
                f"{tag}: process {x['rank']} launched {n}, not "
                f"{cfg['n_layers']} each of K2/K4/K5")
        walls = [statistics.median(x["walls"]) for x in got]
        st = dict(grad_rel_l2_max=max(rel),
                  grad_rel_l2_median=statistics.median(rel),
                  replicated_copies_equal=copies,
                  wall_ms_median=max(walls), wall_ms_min=min(walls),
                  peak_gib_max=max(x["peak_gib"] for x in got),
                  staged_bytes=max(x["staged_bytes"] for x in got),
                  launches=got[0]["launches"])
        stats[tag] = st
        print(f"[grad-parallel] {tag} ({nproc} processes, {cfg['dtype']}, "
              f"{plan['batch']} x {plan['seq']}): the gradient of "
              f"sum(logits * c) within max relative L2 {max(rel):.3g} (median "
              f"{st['grad_rel_l2_median']:.3g}; limit {DP_REL_LIMIT}) of "
              f"{nproc} x the single card's; {copies} replicated copies "
              f"bit-identical; forward + backward {st['wall_ms_median']:.1f} "
              f"ms (median, slowest process; fastest "
              f"{st['wall_ms_min']:.1f}; the single card "
              f"{plan['single_card_ms']:.1f}); peak {st['peak_gib_max']:.2f} "
              f"GiB a process; {st['staged_bytes']} bytes staged through "
              f"the host a process; launches a process "
              f"{json.dumps(st['launches'])} (K1 {k1_want} counted)")
    stats["reference_s"] = t_ref
    stats["processes_s"] = t_procs
    print(f"[grad-parallel] the single-card reference {t_ref:.1f} s, the "
          f"{nproc} processes {t_procs:.1f} s (start included)")
    return stats


# ---------------------------------------------------------------------------
# Phase 21: past CUDA's grid.y/z limit (21a); TP/EP generate and the
# pipelines as processes on the card (21b)
# ---------------------------------------------------------------------------

#: 21a's shapes, each past CUDA's 65,535 blocks on grid.y or grid.z: K2-K5
#: folded heads (Lq = Lk = ``flash_l``, D 16), K8/K11 (row, head) blocks
#: (D 16), K6 cache positions (b 1, one kv head, D 64, bf16, T 1: 65,537
#: splits of 256) and K6 query rows (b 1, one kv head, 32 query heads, D
#: 16, T 65,536 over ``k6_rows_l`` positions: 65,536 row tiles of 32)
GRID = dict(heads=(65536, 70001), flash_l=16, blocks=(65536, 70001),
            k6_positions=65536 * 256 + 1, k6_rows_t=65536, k6_rows_l=384,
            iters=5)
#: CUDA's limit on grid.y and grid.z
MAX_GRID_YZ = 65535
#: the wrappers whose launches each 21a case counts, by its tag's first word
GRID_KERNELS = {"K2-K5": ("flash_block_update_hld", "rowstats", "bwd_dq",
                          "bwd_dkv"),
                "K8": ("write_kv_block",), "K11": ("write_kv_page_block",),
                "K6": ("flash_block_decode",)}


def _launches_past(n: int) -> int:
    """Launches a call makes for ``n`` blocks on grid.y."""
    return -(-n // MAX_GRID_YZ)


def phase_grid_limits(dev) -> dict:
    """21a: every kernel whose grid.y or grid.z is a count the caller
    chooses, past 65,535, against its plain version: K2 and K3-K5 at
    65,536 and 70,001 folded heads in bf16 and f32 (phase 5's and 7's
    tolerances: rtol 1e-4 / atol 1e-4 per unit, K3's counts exactly);
    K8 and K11 at 65,536 and 70,001 (row, head) blocks, k/v pairs,
    bit-equal to indexed assignment; K6 over 65,536 * 256 + 1 positions
    (its entry widens the split) with three planted keys, the last alone
    in the last split, and over 65,536 row tiles (phase 5's rtol 1e-3 /
    atol 2e-3). Each call makes one launch a chunk of 65,535 (one for
    K6's widened split), counted; each is timed by events."""
    import torch
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.kernels import flash as kf

    gen = torch.Generator(device=dev).manual_seed(SEED + 210)
    bf, f32 = torch.bfloat16, torch.float32
    out = {}

    def launched(fn, call):
        before = fn.launches
        res = call()
        torch.cuda.synchronize()
        return res, fn.launches - before

    def timed(call):
        return time_ms(call, iters=GRID["iters"], warmup=1)

    # K2 forward, K3-K5 backward past 65,535 folded heads
    L, d, kw = GRID["flash_l"], 16, dict(causal=True, scale=0.25)
    pos = torch.arange(L, dtype=torch.int32, device=dev).reshape(1, L)
    for h in GRID["heads"]:
        for dtype in (bf, f32):
            tag = f"K2-K5 {h} heads {str(dtype).split('.')[1]}"
            q, k, v = (torch.randn(h, L, d, generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
            m = torch.full((h, 1, L), kf.NEG, device=dev)
            l, o = (torch.zeros(h, 1, L, device=dev),
                    torch.zeros(h, L, d, device=dev))
            fwd = (q, k, v, m, l, o, pos, pos)
            with torch.no_grad():
                got, n2 = launched(kf.flash_block_update_hld, lambda: (
                    kf.flash_block_update_hld(*fwd, **kw)))
                want = kf.flash_block_update_hld_plain(*fwd, **kw)
            for name, g, w in zip("mlo", got, want):
                check(bool(torch.isfinite(g).all()) and
                      _close(g, w, 1e-4, 1e-4),
                      f"21a {tag}: K2 {name} differs from its plain version")
            m2k, m2p = got[0], want[0]
            dl2, do2, route = (torch.randn(h, 1, L, generator=gen,
                                           device=dev),
                               torch.randn(h, L, d, generator=gen,
                                           device=dev),
                               torch.randn(h, 1, L, generator=gen,
                                           device=dev))
            ops = (q, k, v, m2k, dl2, do2, route, pos, pos)
            pops = (q, k, v, m2p, dl2, do2, route, pos, pos)
            cnt, n3 = launched(kf.rowstats, lambda: kf.rowstats(
                q, k, m2k, pos, pos, **kw))
            dq, n4 = launched(kf.bwd_dq, lambda: kf.bwd_dq(*ops, **kw))
            (dk, dv), n5 = launched(kf.bwd_dkv,
                                    lambda: kf.bwd_dkv(*ops, **kw))
            check(torch.equal(cnt, kf.rowstats_plain(q, k, m2p, pos, pos,
                                                     **kw)),
                  f"21a {tag}: K3 counts differ from the plain counts")
            pdq = kf.bwd_dq_plain(*pops, **kw)
            pdk, pdv = kf.bwd_dkv_plain(*pops, **kw)
            err = 0.0
            for what, g, w in (("dq", dq, pdq), ("dk", dk, pdk),
                               ("dv", dv, pdv)):
                check(bool(torch.isfinite(g).all()) and
                      _close(g, w, 1e-4, 1e-4),
                      f"21a {tag}: {what} differs from its plain version")
                err = max(err, abs_err(g, w))
            want_n = _launches_past(h)
            check([n2, n3, n4, n5] == [want_n] * 4,
                  f"21a {tag}: launches K2/K3/K4/K5 {[n2, n3, n4, n5]}, "
                  f"not {want_n} each")
            with torch.no_grad():
                ms2 = timed(lambda: kf.flash_block_update_hld(*fwd, **kw))
            ms345 = timed(lambda: (kf.rowstats(q, k, m2k, pos, pos, **kw),
                                   kf.bwd_dq(*ops, **kw),
                                   kf.bwd_dkv(*ops, **kw)))
            out[tag] = dict(launches=want_n, k2_ms=ms2, k345_ms=ms345,
                            max_abs_err=max(err, abs_err(got[2], want[2])))
            print(f"[grid] 21a {tag} (Lq = Lk = {L}, D {d}, causal): K2 "
                  f"m/l/o and K4/K5 within rtol 1e-4 of the plain versions "
                  f"(max |err| {out[tag]['max_abs_err']:.3g}), K3's counts "
                  f"equal; {want_n} launches a call each; K2 {ms2:.4f} ms, "
                  f"K3 + K4 + K5 {ms345:.4f} ms (events)")
            del q, k, v, m, l, o, got, want, ops, pops, dq, dk, dv, pdq, \
                pdk, pdv, do2

    # K8 and K11 past 65,535 (row, head) blocks, k/v pairs
    D, T, Lc = 16, 8, 32
    for nb, hk in ((GRID["blocks"][0], 1), (1, GRID["blocks"][1])):
        tag = f"K8 {nb} rows x {hk} heads"
        caches = [torch.randn(nb, hk, D, Lc, generator=gen, device=dev)
                  .to(bf) for _ in range(2)]
        rows = [torch.randn(nb, hk, D, T, generator=gen, device=dev).to(bf)
                for _ in range(2)]
        at = torch.randint(0, Lc - T + 1, (nb,), generator=gen, device=dev,
                           dtype=torch.int32)
        got = [c.clone() for c in caches]
        want = [c.clone() for c in caches]
        _, n8 = launched(kd.write_kv_block, lambda: kd.write_kv_block(
            got[0], rows[0], at, got[1], rows[1]))
        kd.write_kv_block_plain(want[0], rows[0], at, want[1], rows[1])
        check(all(same_bits(g, w) for g, w in zip(got, want)),
              f"21a {tag}: K8 differs from indexed assignment")
        check(n8 == _launches_past(nb * hk),
              f"21a {tag}: K8 made {n8} launches")
        ms = timed(lambda: kd.write_kv_block(got[0], rows[0], at, got[1],
                                             rows[1]))
        out[tag] = dict(launches=n8, ms=ms)
        print(f"[grid] 21a {tag} (D {D}, T {T}, k/v pair, bf16): bit-equal "
              f"to indexed assignment, {n8} launches, {ms:.4f} ms (events)")
        del caches, rows, got, want
    for hk in GRID["blocks"]:
        tag = f"K11 {hk} heads"
        pools = [torch.randn(3, hk, D, Lc, generator=gen, device=dev).to(bf)
                 for _ in range(2)]
        rows = [torch.randn(hk, D, T, generator=gen, device=dev).to(bf)
                for _ in range(2)]
        got = [p.clone() for p in pools]
        want = [p.clone() for p in pools]
        _, n11 = launched(kd.write_kv_page_block, lambda: (
            kd.write_kv_page_block(got[0], rows[0], 1, 5, T - 1, got[1],
                                   rows[1])))
        kd.write_kv_page_block_plain(want[0], rows[0], 1, 5, T - 1, want[1],
                                     rows[1])
        check(all(same_bits(g, w) for g, w in zip(got, want)),
              f"21a {tag}: K11 differs from indexed assignment")
        check(n11 == _launches_past(hk), f"21a {tag}: K11 made {n11} "
                                         f"launches")
        ms = timed(lambda: kd.write_kv_page_block(got[0], rows[0], 1, 5,
                                                  T - 1, got[1], rows[1]))
        out[tag] = dict(launches=n11, ms=ms)
        print(f"[grid] 21a {tag} (a {T}-token chunk, {T - 1} valid, into "
              f"page 1 of 3 at lane 5, k/v pair, bf16): bit-equal to indexed "
              f"assignment, {n11} launches, {ms:.4f} ms (events)")
        del pools, rows, got, want

    # K6 past 65,535 splits: three planted keys carry the weight, the last
    # alone in the last split
    Lk, hd, scale = GRID["k6_positions"], 64, 0.125
    q = torch.randn(1, 1, 1, hd, generator=gen, device=dev).to(bf)
    kc = torch.randn(1, 1, hd, Lk, generator=gen, device=dev, dtype=bf)
    vc = torch.randn(1, 1, hd, Lk, generator=gen, device=dev, dtype=bf)
    planted = (100, Lk - 300, Lk - 1)
    for j in planted:
        kc[0, 0, :, j] = q[0, 0, 0] * 4
    got, n6 = launched(kd.flash_block_decode, lambda: kd.flash_block_decode(
        q, kc, vc, Lk - 1, scale))
    want = kd.flash_block_decode_plain(q, kc, vc, Lk - 1, scale,
                                       block_k=1 << 20, split_k=None)
    closed = vc[0, 0][:, list(planted)].float().mean(-1)
    err = abs_err(got, want)
    check(bool(torch.isfinite(got).all()) and
          torch.allclose(got, want, rtol=1e-3, atol=2e-3),
          f"21a K6 over {Lk} positions differs from its plain version "
          f"(max |err| {err:.3g})")
    check(torch.allclose(got[0, 0, 0], closed, rtol=1e-3, atol=1e-3),
          f"21a K6 over {Lk} positions: not the mean of the planted keys' "
          f"values (the last split missed?)")
    check(n6 == 1, f"21a K6 over {Lk} positions made {n6} launches")
    ms6 = timed(lambda: kd.flash_block_decode(q, kc, vc, Lk - 1, scale))
    nbytes = 2 * kc.numel() * kc.element_size()
    out["K6 positions"] = dict(positions=Lk, launches=n6, ms=ms6,
                               bound_ms=nbytes / PEAK_HBM_BYTES_S * 1e3,
                               max_abs_err=err, cache_bytes=nbytes)
    print(f"[grid] 21a K6 over {Lk} positions (b 1, one kv head, D {hd}, "
          f"bf16, T 1; {nbytes / 2 ** 30:.2f} GiB of cache; "
          f"{-(-Lk // kd.SPLIT_K)} splits of {kd.SPLIT_K} widened to "
          f"{-(-Lk // (2 * kd.SPLIT_K))} of {2 * kd.SPLIT_K}): within rtol "
          f"1e-3 / atol 2e-3 of the plain version (max |err| {err:.3g}) and "
          f"of the planted keys' mean value; {n6} launch, {ms6:.4f} ms "
          f"(events; bound {out['K6 positions']['bound_ms']:.4f})")
    del q, kc, vc, got, want

    # K6 past 65,535 row tiles
    T6, L6 = GRID["k6_rows_t"], GRID["k6_rows_l"]
    q = torch.randn(1, T6, 32, 16, generator=gen, device=dev).to(bf)
    kc = torch.randn(1, 1, 16, L6, generator=gen, device=dev).to(bf)
    vc = torch.randn(1, 1, 16, L6, generator=gen, device=dev).to(bf)
    got, n6 = launched(kd.flash_block_decode, lambda: kd.flash_block_decode(
        q, kc, vc, 0, 0.25))
    want = kd.flash_block_decode_plain(q, kc, vc, 0, 0.25)
    err = abs_err(got, want)
    check(bool(torch.isfinite(got).all()) and
          torch.allclose(got, want, rtol=1e-3, atol=2e-3),
          f"21a K6 over {T6 * 32} query rows differs from its plain version "
          f"(max |err| {err:.3g})")
    want_n = _launches_past(-(-T6 * 32 // 32))
    check(n6 == want_n, f"21a K6 over {T6 * 32} query rows made {n6} "
                        f"launches, not {want_n}")
    ms6 = timed(lambda: kd.flash_block_decode(q, kc, vc, 0, 0.25))
    out["K6 rows"] = dict(rows=T6 * 32, launches=n6, ms=ms6,
                          max_abs_err=err)
    print(f"[grid] 21a K6 over {T6 * 32} query rows ({T6} tokens x 32 "
          f"query heads on one kv head, D 16, {L6} positions in "
          f"{-(-L6 // kd.SPLIT_K)} splits, bf16): within rtol 1e-3 / atol "
          f"2e-3 of the plain version (max |err| {err:.3g}); {n6} launches "
          f"of at most 65,535 row tiles, {ms6:.4f} ms (events)")
    del q, kc, vc, got, want
    torch.cuda.empty_cache()
    return out


#: 21b: four gloo processes on the one card, each a rank of a
#: ``DistAxis``: phase 13's TP generate (tp 4, the flagship, batch 32 /
#: plen 1024, ``max_new`` new tokens, the ring tp schedule) and EP
#: generate (ep 4, phase 12's widths, bf16, 'xla' all_to_all), and one
#: GPipe and one 1F1B step at pp 4 (phase 14's flagship at 8 x 1024), each
#: held against the same run on a ``LocalMesh`` on the card
PROC_PARALLEL = dict(procs=4, timeout_s=400.0, max_new=8,
                     tp_algorithm="ring", all_to_all="xla")


def _proc_parallel_consts() -> dict:
    """The module settings 21b reads, carried to the worker processes in
    the plan (a rehearsal shrinks them in the parent only)."""
    return dict(serve=dict(SERVE_CFG), tp=dict(TP_DECODE),
                ep=dict(EP_DECODE), pipe=dict(PIPE), experts=MOE_EXPERTS,
                run=dict(PROC_PARALLEL))


def _proc_parallel_runs(dev, c):
    """21b's configurations and inputs (settings ``c``), made alike in the
    parent (for the ``LocalMesh`` references) and in every worker
    process: {name: (cfg, a maker of the full params, pspecs, inputs)};
    the params from the seed on ``dev``."""
    import dataclasses

    import torch
    from rlo_tpu_torch.models import pipeline as pl
    from rlo_tpu_torch.models import transformer as tt

    gen = torch.Generator(device=dev).manual_seed(SEED + 211)
    cfg = tt.TransformerConfig(**c["serve"])
    b, plen = c["tp"]["batch"], c["tp"]["plen"]
    runs = {"tp": (cfg, lambda: tt.init_params(cfg, seed=SEED + 21,
                                               device=dev),
                   tt.param_pspecs(cfg, "tp"),
                   torch.randint(0, cfg.vocab, (b, plen), generator=gen,
                                 device=dev, dtype=torch.int32))}
    mcfg = dataclasses.replace(tt.TransformerConfig(
        **c["serve"], n_experts=c["experts"],
        capacity_factor=float(c["experts"])), dtype="bfloat16")
    runs["ep"] = (mcfg, lambda: tt.cast_params(tt.init_params(
        mcfg, seed=SEED + 24, device=dev), mcfg.act_dtype),
        tt.param_pspecs(mcfg, ep_axis="ep"),
        torch.randint(0, mcfg.vocab, (c["ep"]["batch"], c["ep"]["plen"]),
                      generator=gen, device=dev, dtype=torch.int32))
    runs["pipe"] = (cfg, lambda: pl.stack_layers(tt.init_params(
        cfg, seed=SEED, device=dev)), pl.pipeline_pspecs("pp", cfg),
        torch.randint(0, cfg.vocab, (c["pipe"]["batch"], c["pipe"]["seq"]),
                      generator=gen, device=dev, dtype=torch.int32))
    return runs


def _proc_parallel_call(name, cfg, p, inputs, ax, c, fn=None):
    """One 21b run on this rank (settings ``c``): TP generate (the whole
    prompt), EP generate (this rank's rows) or a pipelined step ``fn``."""
    from rlo_tpu_torch.models import generate as G
    run = c["run"]
    if name == "tp":
        return G.generate(p, inputs, cfg, max_new=run["max_new"],
                          tp_axis=ax, tp_algorithm=run["tp_algorithm"])
    if name == "ep":
        rows = inputs.chunk(ax.size)[ax.index]
        return G.generate(p, rows, cfg, max_new=run["max_new"], ep_axis=ax,
                          all_to_all_algorithm=run["all_to_all"])
    return fn(p, inputs, cfg, ax, c["pipe"]["n_micro"], lr=SGD_LR)


def _proc_parallel_plan(dev, tmp) -> dict:
    """The ``LocalMesh`` references of 21b on the card, saved to ``tmp``
    (tokens a rank, each pipelined step's new stage params a rank and
    loss), their walls, and the plan the worker processes read."""
    import os

    import torch
    from rlo_tpu_torch.models import pipeline as pl
    from rlo_tpu_torch.parallel.mesh import LocalMesh
    from rlo_tpu_torch.parallel.sharding import shard_tree

    nproc = PROC_PARALLEL["procs"]
    c = _proc_parallel_consts()
    plan = {"count_plain": dev.type == "cpu", "walls": {}, "refs": {},
            "consts": c}
    for name, (cfg, make, specs, inputs) in _proc_parallel_runs(
            dev, c).items():
        mesh = LocalMesh((nproc,), ("x",), device=dev)
        full = make()
        shards = [shard_tree(full, specs, {name if name != "pipe" else "pp":
                                           mesh.axes(r)["x"]})
                  for r in range(nproc)]
        del full
        steps = {"gpipe": pl.pipeline_train_step,
                 "1f1b": pl.pipeline_1f1b_train_step} \
            if name == "pipe" else {name: None}
        for tag, fn in steps.items():
            def body(axes, p, tag=tag, fn=fn):
                with contextlib.ExitStack() as st:
                    if name != "pipe":
                        st.enter_context(torch.no_grad())
                    return _proc_parallel_call(name, cfg, p, inputs,
                                               axes["x"], c, fn)
            _sync(dev)
            t0 = time.perf_counter()
            outs = mesh.run(body, shards)
            _sync(dev)
            plan["walls"][tag] = (time.perf_counter() - t0) * 1e3
            path = os.path.join(tmp, f"ref_{tag}.pt")
            if name == "pipe":
                torch.save([([t.cpu() for t in _leaves(o[0])],
                             o[1].cpu()) for o in outs], path)
            else:
                torch.save([o.cpu() for o in outs], path)
            plan["refs"][tag] = path
            del outs
        del shards, mesh
        _empty(dev)
    return plan


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _empty(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _leaves(tree) -> list:
    from rlo_tpu_torch.models import transformer as tt
    return tt.tree_leaves(tree)


def proc_parallel_worker(argv) -> int:
    """One process of 21b: rank, world size, store path, device type, plan
    path. Runs TP generate, EP generate, a GPipe and a 1F1B step as one
    rank of a gloo ``DistAxis`` and prints a ``PROC-PARALLEL`` JSON line
    for each: whether its result equals the ``LocalMesh`` run's bit for
    bit, the wall, the launches and the bytes staged through the host."""
    rank, ws, store, devtype, plan_path = (int(argv[0]), int(argv[1]),
                                           argv[2], argv[3], argv[4])
    import torch
    if devtype == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device in a phase-21 process",
              file=sys.stderr)
        return 2
    from datetime import timedelta

    import torch.distributed as dist
    from rlo_tpu_torch.kernels import decode as kd
    from rlo_tpu_torch.kernels import flash as kf
    from rlo_tpu_torch.kernels import reduce as k1
    from rlo_tpu_torch.models import pipeline as pl
    from rlo_tpu_torch.parallel.mesh import dist_mesh_axes
    from rlo_tpu_torch.parallel.sharding import shard_tree

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    with open(plan_path) as f:
        plan = json.load(f)
    counted = (k1.fused_combine, kf.flash_block_update_hld, kf.bwd_dq,
               kf.bwd_dkv, kd.flash_block_decode, kd.write_kv_row)
    if plan["count_plain"]:
        # a rehearsal on the CPU: the plain versions count in their
        # wrappers' place
        for mod, wrapper in zip((k1, kf, kf, kf, kd, kd), counted):
            def bump(*a, _orig=getattr(mod, wrapper.__name__ + "_plain"),
                     _w=wrapper, **kw):
                _w.launches += 1
                return _orig(*a, **kw)
            setattr(mod, wrapper.__name__ + "_plain", bump)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if devtype == "cuda" else torch.device("cpu")
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, ws), rank=rank, world_size=ws,
        timeout=timedelta(seconds=PROC_PARALLEL["timeout_s"] / 2))
    c = plan["consts"]
    try:
        ax = dist_mesh_axes((ws,), ("x",), device=dev)["x"]
        # gloo's first collectives set up its pairs: not in a run's wall
        ax.all_reduce(torch.ones(8, device=dev), "sum")
        ax.ppermute(torch.ones(8, device=dev),
                    [(r, (r + 1) % ws) for r in range(ws)])
        for name, (cfg, make, specs, inputs) in _proc_parallel_runs(
                dev, c).items():
            p0 = shard_tree(make(), specs,
                            {name if name != "pipe" else "pp": ax})
            steps = {"gpipe": pl.pipeline_train_step,
                     "1f1b": pl.pipeline_1f1b_train_step} \
                if name == "pipe" else {name: None}
            for tag, fn in steps.items():
                ref = torch.load(plan["refs"][tag], mmap=True)[rank]
                for f in counted:
                    f.launches = 0
                staged0 = ax.staged_bytes
                _sync(dev)
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with contextlib.ExitStack() as st:
                    if name != "pipe":
                        st.enter_context(torch.no_grad())
                    got = _proc_parallel_call(name, cfg, p0, inputs, ax, c,
                                              fn)
                _sync(dev)
                wall = (time.perf_counter() - t0) * 1e3
                line = dict(tag=tag, rank=rank, wall_ms=wall,
                            staged_bytes=ax.staged_bytes - staged0,
                            launches={f.__name__: f.launches
                                      for f in counted},
                            peak_gib=torch.cuda.max_memory_allocated()
                            / 2 ** 30 if dev.type == "cuda" else 0.0)
                if name == "pipe":
                    # the step again, warm: the first carries the
                    # process's first backward
                    _sync(dev)
                    t1 = time.perf_counter()
                    _proc_parallel_call(name, cfg, p0, inputs, ax, c, fn)
                    _sync(dev)
                    line["warm_wall_ms"] = (time.perf_counter() - t1) * 1e3
                    new, loss = got
                    leaves = [t.cpu() for t in _leaves(new)]
                    old = [t.cpu() for t in _leaves(p0)]
                    line["equal"] = bool(torch.equal(loss.cpu(), ref[1])) \
                        and all(torch.equal(g, w)
                                for g, w in zip(leaves, ref[0]))
                    line["update_rel_l2_max"] = max(
                        float((g.double() - w.double()).norm()
                              / max(float((w.double() - o.double()).norm()),
                                    1e-300))
                        for g, w, o in zip(leaves, ref[0], old))
                    line["loss"] = float(loss)
                else:
                    line["equal"] = bool(torch.equal(got.cpu(), ref))
                    line["tokens"] = list(got.shape)
                print("PROC-PARALLEL " + json.dumps(line), flush=True)
                del got
            del p0
            _empty(dev)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def phase_proc_parallel(dev) -> dict:
    """21b (see the module docstring): the ``LocalMesh`` references here,
    then ``PROC_PARALLEL['procs']`` processes ``chip_smoke.py
    --proc-parallel-worker`` over gloo on the one card; every process's
    tokens (TP, EP) and stage update and loss (GPipe, 1F1B) bit-equal to
    the reference's."""
    nproc = PROC_PARALLEL["procs"]
    plan, lines, t_ref, t_procs = _rank_processes(
        dev, _proc_parallel_plan, "--proc-parallel-worker", nproc,
        PROC_PARALLEL["timeout_s"], 21, "PROC-PARALLEL")
    stats = {}
    for tag in ("tp", "ep", "gpipe", "1f1b"):
        got = sorted((x for x in lines if x["tag"] == tag),
                     key=lambda x: x["rank"])
        check(len(got) == nproc, f"21b {tag}: {len(got)} of {nproc} "
                                 f"processes reported")
        for x in got:
            check(x["equal"], f"21b {tag}: process {x['rank']}'s result is "
                              f"not the LocalMesh run's bits"
                              + (f" (update relative L2 "
                                 f"{x['update_rel_l2_max']:.3g})"
                                 if "update_rel_l2_max" in x else ""))
        launches = got[0]["launches"]
        if tag in ("tp", "ep"):
            for k in ("flash_block_update_hld", "flash_block_decode",
                      "write_kv_row"):
                check(all(x["launches"][k] > 0 for x in got),
                      f"21b {tag}: {k} was not launched in every process")
        if tag == "tp":
            check(all(x["launches"]["fused_combine"] > 0 for x in got),
                  "21b tp: K1 was not launched in every process")
        if tag in ("gpipe", "1f1b"):
            for k in ("flash_block_update_hld", "bwd_dq", "bwd_dkv"):
                check(all(x["launches"][k] > 0 for x in got),
                      f"21b {tag}: {k} was not launched in every process")
        walls = [x["wall_ms"] for x in got]
        warm = [x["warm_wall_ms"] for x in got if "warm_wall_ms" in x]
        stats[tag] = dict(wall_ms_max=max(walls), wall_ms_min=min(walls),
                          warm_wall_ms_max=max(warm, default=None),
                          local_mesh_ms=plan["walls"][tag],
                          staged_bytes=[x["staged_bytes"] for x in got],
                          peak_gib_max=max(x["peak_gib"] for x in got),
                          launches=[x["launches"] for x in got])
        print(f"[proc-parallel] 21b {tag} over {nproc} gloo processes: "
              f"bit-equal to the LocalMesh run's on every process; wall "
              f"{min(walls):.1f}-{max(walls):.1f} ms a process"
              + (f" (again, warm: up to {max(warm):.1f} ms)" if warm else "")
              + f" (the LocalMesh {plan['walls'][tag]:.1f} ms); staged "
              f"through the "
              f"host {stats[tag]['staged_bytes']} bytes a process; peak "
              f"{stats[tag]['peak_gib_max']:.2f} GiB; launches a process "
              f"{json.dumps(stats[tag]['launches'])}")
    stats["reference_s"], stats["processes_s"] = t_ref, t_procs
    print(f"[proc-parallel] the LocalMesh references {t_ref:.1f} s, the "
          f"{nproc} processes {t_procs:.1f} s (start included)")
    return stats


def _to_device(tree, device):
    return _tree_map(lambda t: t.to(device), tree)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def cards_line() -> str:
    """How many cards the machine has, as ``nvidia-smi -L`` lists them
    (read before ``pin_one_card`` hides all but the first)."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], check=True,
                             capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"[cards] nvidia-smi -L failed: {e}"
    n = sum(line.startswith("GPU ") for line in out.splitlines())
    return f"[cards] nvidia-smi -L lists {n} card(s)"


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
    ones on the CUDA cores: count tensor-core instructions (HMMA, and
    HGMMA for wgmma) per kernel in the SASS of the built flash library
    (``cuobjdump`` beside ``nvcc``). K4 and K5 run every product there,
    K3 only its scores: each bf16 K4/K5 must hold more of them than K3
    at the same head dim."""
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
        elif fn and ("HMMA" in line or "HGMMA" in line):
            hmma[fn] += 1
    kinds = {"K2": "flash_fwd_", "K3": "flash_rowstats_",
             "K4": "flash_bwd_dq_", "K5": "flash_bwd_dkv_"}
    seen = {}
    for fn, n in hmma.items():
        if "flash_bwd_dkv_prep_kernel" in fn:
            continue  # K5's prepass: no products, no head-dim instance
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


#: what one launch of a block write does, for the kernels line
PAIR_LAUNCH = ("one launch writes a k/v pair (or the int8 scale pair), "
               "where the parent tree took two launches and two copies")


def kernel_entry(name, source, replaces, launches, st, path,
                 **extra) -> dict:
    """One kernel of the ``kernels`` line; ``path`` names the run whose
    launches it counts. A write's device times (the profiler) and its
    k/v pair's times ride along where the phase measured them."""
    out = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "path": path,
           "max_abs_err": st["max_abs_err"], "ms": st["ms"],
           "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
           "bound_by": st["bound_by"], "library_ms": st["library_ms"]}
    out.update({k: v for k, v in st.items()
                if k.startswith(("device_", "library_device", "host_",
                                 "library_host", "path_", "contiguous_",
                                 "misaligned_", "empty_",
                                 "one_column_"))})
    out.update(extra)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--multihost-worker"]:
        return multihost_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--train-parallel-worker"]:
        return train_parallel_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--proc-parallel-worker"]:
        return proc_parallel_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--grad-parallel-worker"]:
        return grad_parallel_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--host-worker"]:
        return host_worker(sys.argv[2:])
    if sys.argv[1:] == ["--hostile-worker"]:
        return hostile_worker()
    print(cards_line())
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
    if sys.argv[1:] == ["--time-decode"]:
        from rlo_tpu_torch.kernels import build
        build.load("decode")
        times = time_attend(dev, torch.Generator(device=dev).manual_seed(
            SEED + 12))
        windows_line("time-decode")
        print(json.dumps(times))
        return 0
    if sys.argv[1:] == ["--time-k3"]:
        from rlo_tpu_torch.kernels import build
        build.load("flash")
        times = time_k3(dev)
        windows_line("time-k3")
        print(json.dumps(times))
        return 0
    if sys.argv[1:] == ["--time-flash"]:
        from rlo_tpu_torch.kernels import build
        build.load("flash")
        times = time_flash(dev)
        windows_line("time-flash")
        print(json.dumps(times))
        return 0
    if sys.argv[1:] == ["--time-writes"]:
        from rlo_tpu_torch.kernels import build
        build.load("decode")
        build.load("reduce")
        gen = torch.Generator(device=dev).manual_seed(SEED + 11)
        times = {"K7": time_k7(dev, gen), "K8": time_k8(dev, gen),
                 "K10": time_k10(dev, gen),
                 "K11": time_k11(dev, gen), "K1": time_k1(dev, gen, N_FULL)}
        windows_line("time-writes")
        print(json.dumps(times))
        return 0
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")
    t0 = time.perf_counter()
    build_all()
    print(f"[build] csrc/{{reduce,flash,decode}}.cu built with nvcc (in "
          f"parallel) and loaded in {time.perf_counter() - t0:.1f} s")
    check_tensor_cores()

    k1_stats = phase_k1(dev, N_FULL)
    windows_line("k1")

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
    windows_line("k7/k8")
    k9_stats = phase_k9(dev)
    pw_stats = phase_page_writes(dev)
    windows_line("k10/k11")
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
    windows_line("k3-k5")
    torch.cuda.empty_cache()
    # the VJP modes; K3's launches are those of its exact-mode chain
    vjp = phase_vjp(dev)
    torch.cuda.empty_cache()
    # the training path: the full-width step and the dp combine
    trained = (k1.fused_combine, k2.flash_block_update_hld, k2.bwd_dq,
               k2.bwd_dkv, k2.bwd_dkv_prep)
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
    _one_prep_a_k5(train_launches, "the training path")
    del train["params"], train["grads"]
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    spec = phase_speculative(dev, (kd.flash_block_decode, kd.write_kv_row,
                                   kd.write_kv_block))
    print(f"[spec] speculative decoding phase took "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    moe_counted = (k2.flash_block_update_hld, k2.bwd_dq, k2.bwd_dkv,
                   kd.flash_block_decode, kd.write_kv_row, kd.write_kv_block,
                   kd.paged_flash_decode, kd.write_kv_page_row)
    for fn in moe_counted:
        fn.launches = 0
    t0 = time.perf_counter()
    moe = phase_moe(dev, (k2.flash_block_update_hld, k2.rowstats, k2.bwd_dq,
                          k2.bwd_dkv))
    moe_launches = {fn.__name__: fn.launches for fn in moe_counted}
    print(f"[moe] MoE phase took {time.perf_counter() - t0:.1f} s, launches "
          f"{json.dumps(moe_launches)}")
    for fn in moe_counted:
        check(moe_launches[fn.__name__] > 0,
              f"{fn.__name__} was not launched on the MoE paths")
    torch.cuda.empty_cache()
    par_counted = (k1.fused_combine, k2.flash_block_update_hld,
                   kd.flash_block_decode, kd.write_kv_row, kd.write_kv_block)
    t0 = time.perf_counter()
    par = phase_parallel(dev, par_counted)
    par_paths = par.pop("launches_by_path")
    print(f"[parallel] phase 13 took {time.perf_counter() - t0:.1f} s, "
          f"launches by path {json.dumps(par_paths)}")
    windows_line("phases 8-13")
    for fn in par_counted:
        check(any(n.get(fn.__name__, 0) > 0 for n in par_paths.values()),
              f"{fn.__name__} was not launched on the model-parallel paths")
    for path in ("tp_generate", "ep_generate_bfloat16_xla"):
        for name in ("flash_block_decode", "write_kv_row"):
            check(par_paths[path][name] > 0,
                  f"{name} was not launched on {path}")
    check(par_paths["tp_gqa_bf16"]["write_kv_block"] > 0,
          "write_kv_block was not launched on the TP block decode")
    torch.cuda.empty_cache()
    pipe_counted = (k2.flash_block_update_hld, k2.bwd_dq, k2.bwd_dkv)
    for fn in (*pipe_counted, k2.bwd_dkv_prep):
        fn.launches = 0
    t0 = time.perf_counter()
    pipe = phase_pipeline(dev, pipe_counted)
    pipe_launches = {fn.__name__: fn.launches
                     for fn in (*pipe_counted, k2.bwd_dkv_prep)}
    print(f"[pipeline] phase 14 took {time.perf_counter() - t0:.1f} s, "
          f"launches {json.dumps(pipe_launches)}")
    _one_prep_a_k5(pipe_launches, "the pipelined paths")
    for fn in pipe_counted:
        check(pipe_launches[fn.__name__] > 0,
              f"{fn.__name__} was not launched on the pipelined paths")
        for name in ("gpipe", "1f1b"):
            check(pipe[name]["launches_per_step"][fn.__name__] > 0,
                  f"{fn.__name__} was not launched in a {name} step")
    torch.cuda.empty_cache()

    k1.fused_combine.launches = 0
    t0 = time.perf_counter()
    bridge = phase_bridge(dev, N_FULL)
    bridge_launches = bridge["k1_gated_launches"]
    print(f"[bridge] phase 15a/c took {time.perf_counter() - t0:.1f} s, "
          f"K1 launches {k1.fused_combine.launches} over the phase, "
          f"{bridge_launches} of them on the gated path (the rest by the "
          f"ungated calls it is held against)")
    check(k1.fused_combine.launches >= bridge_launches > 0,
          "K1 was not launched on the bridge path")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    multihost = phase_multihost(dev)
    print(f"[multihost] phase 15b took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_par = phase_train_parallel(dev)
    print(f"[train-parallel] phase 16 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    # phase 17's span dumps are read by phase 19
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as span_dir:
        t0 = time.perf_counter()
        fabric = phase_fabric(dev, counted, span_dir)
        print(f"[fabric] phase 17 took {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        # the host facades: K1 runs only in the TorchBackend calls they
        # are held against (the facades themselves compute on the host)
        k1.fused_combine.launches = 0
        t0 = time.perf_counter()
        host = phase_host_facades(dev, N_FULL)
        host["procs"] = phase_host_procs(dev, N_FULL)
        host_launches = k1.fused_combine.launches
        print(f"[host] phase 18 took {time.perf_counter() - t0:.1f} s, K1 "
              f"launches {host_launches} (all in the TorchBackend calls "
              f"the facades are held against)")
        check(host_launches > 0, "K1 was not launched by the TorchBackend "
              "references of phase 18")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tools = phase_tools(dev, N_FULL, span_dir,
                            fabric["17a dense"]["victim"])
        tools_launches = tools["k1_launches_19b"]
        print(f"[tools] phase 19 took {time.perf_counter() - t0:.1f} s, "
              f"K1 launches {tools_launches} in 19b")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    grads = phase_grad_parallel(dev)
    print(f"[grad-parallel] phase 20 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    grid = phase_grid_limits(dev)
    print(f"[grid] phase 21a took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    proc_par = phase_proc_parallel(dev)
    print(f"[proc-parallel] phase 21b took {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"facade_allreduce": facade, "serving": serving,
                      "paged_serving": paged,
                      "k9_int8": k9_stats["int8"], "vjp": vjp,
                      "training": train["stats"], "dp_combine": dp,
                      "speculative": spec, "moe": moe, "parallel": par,
                      "pipeline": pipe, "bridge": bridge,
                      "multihost": multihost,
                      "train_parallel": train_par, "fabric": fabric,
                      "host_facades": host, "tools": tools,
                      "collective_grads": grads, "grid_limits": grid,
                      "proc_parallel": proc_par}))
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    # the path whose run counted each kernel's launches
    facade_p, serve_p = "facade (phase 3)", "dense serving (phase 5)"
    paged_p = "paged serving (phase 6)"
    chain_p = "exact-mode chained block update (phase 8)"
    train_p = "training step and dp combine (phases 9-10)"
    spec_p, moe_p = "speculative decoding (phase 11)", "MoE (phase 12)"

    def by_path(name):
        """The kernel's launches on the later slices' paths."""
        out = {moe_p: moe_launches[name]} if name in moe_launches else {}
        if name in spec["launches"]:
            out[spec_p] = spec["launches"][name]
        for path, counts in par_paths.items():
            if counts.get(name):
                out[f"{path} (phase 13)"] = counts[name]
        for sched in ("gpipe", "1f1b"):
            n = pipe[sched]["launches_per_step"].get(name)
            if n:
                out[f"pipeline {sched} step, pp 4 (phase 14)"] = n
        if name == "fused_combine":
            out["bridge"] = bridge_launches
            out["TorchBackend references of the host facades (phase "
                "18)"] = host_launches
            out["byte pinning's schedules (phase 19b)"] = tools_launches
        for tag, _, _, _ in TRAIN_PARALLEL_RUNS:
            n = train_par[tag]["launches_per_step"].get(name)
            if n:
                out[f"{tag} step, each process (phase 16)"] = n
        for tag in ("17a dense", "17b paged"):
            n = fabric[tag]["launches"].get(name)
            if n:
                out[f"fabric {tag} fleet, 4 ranks (phase 17)"] = n
        for alg in GRAD_TP_ALGORITHMS:
            tag = f"20c tp {GRAD_PARALLEL['procs']} {alg}"
            n = grads[tag]["launches"].get(name)
            if n:
                out[f"{tag} forward + backward, each process (phase 20)"] = n
        if name == "fused_combine":
            out["20b differentiable collectives, each process, forwards "
                "(phase 20)"] = sum(c["k1_forward"]
                                    for c in grads["20b"].values())
        for tag, st in grid.items():
            if name in GRID_KERNELS.get(tag.split()[0], ()):
                out[f"21a {tag}, a call (phase 21)"] = st["launches"]
        for tag in ("tp", "ep", "gpipe", "1f1b"):
            n = [x.get(name, 0) for x in proc_par[tag]["launches"]]
            if any(n):
                out[f"21b {tag} over {PROC_PARALLEL['procs']} processes, "
                    f"each (phase 21)"] = n
        return {"launches_by_path": out} if out else {}
    print(json.dumps({"kernels": [
        kernel_entry("K1 fused_combine", K1_SOURCE, K1_REPLACES, launches,
                     dict(k1_stats["256MB"],
                          max_abs_err=k1_stats["max_abs_err"]), facade_p,
                     ring_chunk=k1_stats["ring_chunk"],
                     **by_path("fused_combine")),
        kernel_entry("K2 flash_block_update_hld", FLASH_SOURCE,
                     "rlo_tpu/pallas/flash.py:114",
                     served["flash_block_update_hld"], k2_stats["prefill"],
                     serve_p, **by_path("flash_block_update_hld")),
        kernel_entry("K6 flash_block_decode", DECODE_SOURCE,
                     "rlo_tpu/pallas/decode.py:70",
                     served["flash_block_decode"], k6_stats["bf16"], serve_p,
                     **by_path("flash_block_decode"),
                     split_k=kd.SPLIT_K, int8={
                         k: k6_stats["int8"][k]
                         for k in ("ms", "device_ms", "bound_ms")}),
        kernel_entry("K7 write_kv_row", DECODE_SOURCE,
                     "rlo_tpu/pallas/decode.py:141",
                     served["write_kv_row"], w_stats["K7"], serve_p,
                     launch_unit=PAIR_LAUNCH, **by_path("write_kv_row")),
        kernel_entry("K8 write_kv_block", DECODE_SOURCE,
                     "rlo_tpu/pallas/decode.py:168",
                     served["write_kv_block"], w_stats["K8"], serve_p,
                     launch_unit=PAIR_LAUNCH, **by_path("write_kv_block")),
        kernel_entry("K9 paged_flash_decode", DECODE_SOURCE,
                     "rlo_tpu/pallas/decode.py:466",
                     paged_launches["paged_flash_decode"], k9_stats["bf16"],
                     paged_p, split_k=kd.SPLIT_K,
                     **by_path("paged_flash_decode"),
                     k6_same_columns_device_ms=k9_stats["bf16"][
                         "k6_device_ms"],
                     int8={k: k9_stats["int8"][k]
                           for k in ("ms", "device_ms", "bound_ms",
                                     "k6_device_ms")}),
        kernel_entry("K10 write_kv_page_row", DECODE_SOURCE,
                     "rlo_tpu/pallas/decode.py:350",
                     paged_launches["write_kv_page_row"], pw_stats["K10"],
                     paged_p, launch_unit=PAIR_LAUNCH,
                     **by_path("write_kv_page_row")),
        kernel_entry("K11 write_kv_page_block", DECODE_SOURCE,
                     "rlo_tpu/pallas/decode.py:402",
                     paged_launches["write_kv_page_block"], pw_stats["K11"],
                     paged_p, launch_unit=PAIR_LAUNCH,
                     **by_path("write_kv_page_block")),
        kernel_entry("K3 rowstats", FLASH_SOURCE,
                     "rlo_tpu/pallas/flash.py:249", vjp["k3_launches"],
                     k345_stats["K3"], chain_p, **by_path("rowstats")),
        kernel_entry("K4 bwd_dq", FLASH_SOURCE,
                     "rlo_tpu/pallas/flash.py:296",
                     train_launches["bwd_dq"], k345_stats["K4"], train_p,
                     **by_path("bwd_dq")),
        kernel_entry("K5 bwd_dkv", FLASH_SOURCE,
                     "rlo_tpu/pallas/flash.py:320",
                     train_launches["bwd_dkv"], k345_stats["K5"], train_p,
                     **by_path("bwd_dkv"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
