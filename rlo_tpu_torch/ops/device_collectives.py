"""Rootless collectives as per-rank PyTorch functions over an ``Axis``.

The port of ``rlo_tpu/ops/tpu_collectives.py``: the same ops, schedules
and cost models, with the JAX per-shard function (under ``shard_map``
over a named axis) turned into a per-rank function that is handed its
``Axis`` (``rlo_tpu_torch.parallel.mesh``). ``lax.ppermute`` becomes
``axis.ppermute``, ``psum``/``pmin``/``pmax`` ``axis.all_reduce``,
``lax.all_gather`` ``axis.all_gather``; traced indices are plain Python
ints per rank, and the ``fori_loop`` bodies are Python loops.

The per-step combine is kernel K1 (``kernels.reduce.fused_combine``).
``use_kernel``: True (the default) -> ``fused_combine``, which launches K1 on
CUDA tensors and takes its plain version on CPU tensors; False -> the
plain version everywhere (the counterpart of the JAX package's ``jnp``
path).
Accumulating steps write into a buffer the op owns (``out=``), never
into the caller's tensor.

Under autograd (grad mode on and an input that needs a gradient) the
ops of a training path differentiate as JAX's transpose rules do
(``parallel.autodiff``): ``allreduce(algorithm='psum')`` is a sum into a
value every rank holds alike (its backward the identity), and
``all_to_all`` of every schedule moves the cotangent back the way it
came. The manual allreduce schedules and ``hierarchical_allreduce``
accumulate in place and have no backward: under autograd they raise.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from rlo_tpu_torch import topology
from rlo_tpu_torch.kernels.reduce import (OPS, fused_combine,
                                          fused_combine_plain)
from rlo_tpu_torch.parallel import autodiff


def _combiner(op: str, use_kernel: bool) -> Callable:
    """``combine(a, b, out=None)`` for one op."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}")
    fn = fused_combine if use_kernel else fused_combine_plain
    return functools.partial(fn, op=op)


#: Step hook: ``hook(algorithm, step, ws)`` once per executed step of the
#: unrolled schedules (the same places and algorithm names as the JAX
#: package's trace-time hook), fired by the axis's leader rank only, so a
#: LocalMesh reports each step once. None disables it.
_STEP_HOOK = None


def set_step_hook(fn):
    """Install ``fn(algorithm, step, ws)`` as the step hook (None
    disables). Returns the previous hook for restore."""
    global _STEP_HOOK
    prev = _STEP_HOOK
    _STEP_HOOK = fn
    return prev


def _hook(axis, alg: str, step: int) -> None:
    if _STEP_HOOK is not None and axis.leader:
        _STEP_HOOK(alg, step, axis.size)


# ---------------------------------------------------------------------------
# Rootless broadcast
# ---------------------------------------------------------------------------

def rootless_bcast(x: torch.Tensor, origin: int, axis, *,
                   schedule: str = "binomial") -> torch.Tensor:
    """Broadcast ``x`` from rank ``origin`` to every rank of ``axis``.

    schedule: 'binomial' (ceil(log2 n) rounds), 'skip_ring' (the
    reference overlay's tree, more rounds) or 'gather' (all_gather, then
    pick the origin's row)."""
    ws = axis.size
    if schedule == "gather":
        return axis.all_gather(x)[origin]
    if schedule == "binomial":
        sched = topology.binomial_bcast_schedule(ws, origin)
        alg = "binomial_bcast"
    elif schedule == "skip_ring":
        sched = topology.skip_ring_bcast_schedule(ws, origin)
        alg = "skip_ring_bcast"
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    for s, rnd in enumerate(sched.rounds):
        _hook(axis, alg, s)
        recv = axis.ppermute(x, rnd)
        if axis.index in {d for _, d in rnd}:
            x = recv
    return x


# ---------------------------------------------------------------------------
# Cost models (restated from the JAX package; tests pin them equal)
# ---------------------------------------------------------------------------

def _default_pipeline_chunks(device=None) -> int:
    """2 on CUDA, 1 on the CPU (every transfer there shares one memory
    bus, so extra sub-chunks are pure overhead). ``device=None`` means
    the card when there is one."""
    if device is None:
        return 2 if torch.cuda.is_available() else 1
    return 2 if torch.device(device).type == "cuda" else 1


def allreduce_cost(algorithm: str, ws: int, nbytes: int, *,
                   itemsize: int = 4,
                   pipeline_chunks: Optional[int] = None,
                   device=None) -> dict:
    """Analytic per-rank cost of the manual allreduce schedules: steps,
    bytes per ring direction (None for XOR schedules), total bytes sent
    per rank, and the number of ppermutes. Padding is modelled at element
    granularity, as the schedules pad. ``pipeline_chunks=None`` resolves
    as ``allreduce`` resolves it on ``device``."""
    if ws < 1 or nbytes < 0:
        raise ValueError("ws >= 1 and nbytes >= 0 required")
    if pipeline_chunks is not None and pipeline_chunks < 1:
        raise ValueError("pipeline_chunks >= 1 required")
    if nbytes % itemsize:
        raise ValueError(f"nbytes {nbytes} not a multiple of itemsize "
                         f"{itemsize}")
    if ws == 1:
        return {"steps": 0, "fwd_bytes": 0, "bwd_bytes": 0,
                "total_bytes": 0, "n_permutes": 0}
    if pipeline_chunks is None:
        pipeline_chunks = _default_pipeline_chunks(device)
    nq = pipeline_chunks
    nelems = nbytes // itemsize
    if algorithm == "ring":
        chunk = -(-nelems // ws) * itemsize
        return {"steps": 2 * (ws - 1),
                "fwd_bytes": 2 * (ws - 1) * chunk, "bwd_bytes": 0,
                "total_bytes": 2 * (ws - 1) * chunk,
                "n_permutes": 2 * (ws - 1)}
    if algorithm == "bidir_ring":
        sub = -(-nelems // (2 * ws * nq)) * itemsize
        per_dir = 2 * (ws - 1) * nq * sub
        return {"steps": 2 * (ws - 1),
                "fwd_bytes": per_dir, "bwd_bytes": per_dir,
                "total_bytes": 2 * per_dir,
                "n_permutes": 4 * (ws - 1) * nq}
    if algorithm == "recursive_doubling":
        if not topology.is_power_of_2(ws):
            raise ValueError("recursive_doubling requires power-of-2")
        k = ws.bit_length() - 1
        return {"steps": k, "fwd_bytes": None, "bwd_bytes": None,
                "total_bytes": k * nbytes, "n_permutes": k}
    if algorithm == "halving_doubling":
        if not topology.is_power_of_2(ws):
            raise ValueError("halving_doubling requires power-of-2")
        k = ws.bit_length() - 1
        chunk = -(-nelems // ws) * itemsize
        return {"steps": 2 * k, "fwd_bytes": None, "bwd_bytes": None,
                "total_bytes": 2 * (ws - 1) * chunk, "n_permutes": 2 * k}
    raise ValueError(f"no cost model for algorithm {algorithm!r}")


def hierarchical_allreduce_cost(wi: int, wd: int, nbytes: int, *,
                                ici_algorithm: str = "auto",
                                dcn_algorithm: str = "psum",
                                itemsize: int = 4) -> dict:
    """Per-rank, per-tier bytes of ``hierarchical_allreduce``: the inner
    (ici) axis's reduce-scatter + all-gather, and the scattered shard's
    crossing of the outer (dcn) axis."""
    if wi < 1 or wd < 1 or nbytes < 0:
        raise ValueError("wi, wd >= 1 and nbytes >= 0 required")
    if nbytes % itemsize:
        raise ValueError(f"nbytes {nbytes} not a multiple of itemsize "
                         f"{itemsize}")
    nelems = nbytes // itemsize
    chunk_elems = -(-nelems // wi)
    chunk = chunk_elems * itemsize
    pow2 = topology.is_power_of_2(wi)
    rs_halving = pow2 and ici_algorithm in ("auto", "halving")
    ag_doubling = pow2
    if wi == 1:
        ici_bytes, ici_steps, ici_permutes = 0, 0, 0
    else:
        k = wi.bit_length() - 1
        if rs_halving:
            rs_bytes, rs_steps, rs_perms = (wi - 1) * chunk, k, k
        else:
            rs_bytes = wi * chunk
            rs_steps = rs_perms = wi
        if ag_doubling:
            ag_bytes, ag_steps, ag_perms = (wi - 1) * chunk, k, k
        else:
            ag_bytes = (wi - 1) * chunk
            ag_steps = ag_perms = wi - 1
        ici_bytes = rs_bytes + ag_bytes
        ici_steps = rs_steps + ag_steps
        ici_permutes = rs_perms + ag_perms
    m = chunk_elems
    dcn_psum = 2 * m * itemsize * (wd - 1) // wd
    if wd == 1:
        dcn_bytes = 0
    elif dcn_algorithm == "psum":
        dcn_bytes = dcn_psum
    elif dcn_algorithm == "int8":
        dcn_bytes = (wd - 1) * (m + 4)
    else:
        dcn_bytes = allreduce_cost(dcn_algorithm, wd, m * itemsize,
                                   itemsize=itemsize)["total_bytes"]
    return {
        "ici_bytes": ici_bytes, "ici_steps": ici_steps,
        "ici_permutes": ici_permutes,
        "dcn_bytes": dcn_bytes,
        "dcn_elems": m if wd > 1 else 0,
        "dcn_bytes_flat": 2 * nbytes * (wd - 1) // wd,
        "dcn_compression": (dcn_psum / dcn_bytes
                            if dcn_bytes else float("inf")),
    }


def all_to_all_cost(algorithm: str, ws: int, nbytes: int, *,
                    itemsize: int = 4) -> dict:
    """Per-rank bytes of ``all_to_all`` (``nbytes`` = the whole per-rank
    buffer): bytes handed to ppermute, and chunk-bytes x ring hops."""
    if ws < 1 or nbytes < 0:
        raise ValueError("ws >= 1 and nbytes >= 0 required")
    if ws > 1 and nbytes % ws:
        raise ValueError(f"nbytes {nbytes} must divide by ws {ws} "
                         f"(the leading axis must equal the axis size)")
    if ws == 1:
        return {"steps": 0, "injected_bytes": 0, "link_hop_bytes": 0,
                "n_permutes": 0}
    chunk = nbytes // ws
    if algorithm in ("direct", "xla"):
        hops = ws * (ws - 1) // 2 * chunk
        return {"steps": ws - 1, "injected_bytes": (ws - 1) * chunk,
                "link_hop_bytes": hops,
                "n_permutes": ws - 1 if algorithm == "direct" else 0}
    if algorithm == "ring":
        return {"steps": ws - 1,
                "injected_bytes": (ws - 1) * nbytes,
                "link_hop_bytes": (ws - 1) * nbytes,
                "n_permutes": ws - 1}
    raise ValueError(f"no cost model for algorithm {algorithm!r}")


# ---------------------------------------------------------------------------
# Allreduce / reduce-scatter / all-gather
# ---------------------------------------------------------------------------

def allreduce(x: torch.Tensor, axis, *, op: str = "sum",
              algorithm: str = "auto", use_kernel: bool = True,
              pipeline_chunks: Optional[int] = None) -> torch.Tensor:
    """Reduction of every rank's ``x`` over ``axis``, replicated.

    algorithm: 'psum' (the transport's own all-reduce, the baseline),
    'ring' (reduce-scatter + all-gather, K1 per step), 'bidir_ring' (both
    ring directions carry half the payload, each row cut into
    ``pipeline_chunks`` sub-chunks; None -> 2 on CUDA, 1 on the CPU),
    'recursive_doubling' and 'halving_doubling' (power-of-2 only).
    'auto' is psum. Under autograd only psum's sum differentiates."""
    if pipeline_chunks is None:
        pipeline_chunks = _default_pipeline_chunks(x.device)
    if algorithm == "auto":
        algorithm = "psum"
    if algorithm == "psum":
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}")
        if op == "sum":
            return autodiff.psum_invariant(x, axis)
        _no_backward(x, f"allreduce(op={op!r})")
        return axis.all_reduce(x, op)
    _no_backward(x, f"allreduce(algorithm={algorithm!r})")
    if algorithm == "recursive_doubling":
        return _allreduce_rd(x, axis, op, use_kernel)
    if algorithm == "bidir_ring":
        return _bidir_ring_allreduce(x, axis, op, use_kernel,
                                     pipeline_chunks)
    if algorithm == "ring":
        chunks, meta = _chunk_shard(x, axis.size)
        _, reduced = _ring_reduce_scatter(chunks, axis, op, use_kernel)
        return _unchunk_shard(_ring_all_gather_rolled(reduced, axis), meta)
    if algorithm == "halving_doubling":
        chunks, meta = _chunk_shard(x, axis.size)
        reduced = _halving_reduce_scatter(chunks, axis, op, use_kernel)
        return _unchunk_shard(_doubling_all_gather(reduced, axis), meta)
    raise ValueError(f"unknown algorithm {algorithm!r}")


def _no_backward(x, what: str) -> None:
    if autodiff.needs_grad(x):
        raise NotImplementedError(
            f"{what} has no backward (its steps accumulate in place): "
            f"under autograd sum with algorithm='psum', the JAX package's "
            f"training path")


def _allreduce_rd(x, axis, op: str, use_kernel):
    ws = axis.size
    if not topology.is_power_of_2(ws):
        raise ValueError("recursive_doubling requires power-of-2 axis size")
    combine = _combiner(op, use_kernel)
    x = x.contiguous()
    for s, rnd in enumerate(topology.recursive_doubling_rounds(ws)):
        _hook(axis, "recursive_doubling", s)
        other = axis.ppermute(x, rnd)
        x = combine(x, other)
    return x


def _bidir_ring_allreduce(x, axis, op: str, use_kernel,
                          pipeline_chunks: int = 2):
    """Bidirectional chunked ring: the flat payload's forward half rings
    rank -> rank+1 and its backward half rank -> rank-1, each cut into
    ws rows of ``pipeline_chunks`` sub-chunks. The halves are rolled so
    local row j holds global chunk (j + rank), which makes every row
    index below the same on every rank and reproduces the JAX schedule's
    association order exactly."""
    ws = axis.size
    if ws == 1:
        return x
    combine = _combiner(op, use_kernel)
    idx = axis.index
    nq = pipeline_chunks
    shape, n = x.shape, x.numel()
    flat = x.reshape(-1)
    pad = (-n) % (2 * ws * nq)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    halves = torch.roll(flat.reshape(2, ws, nq, -1), -idx, dims=1)
    fwd = [[halves[0, i, q] for q in range(nq)] for i in range(ws)]
    bwd = [[halves[1, i, q] for q in range(nq)] for i in range(ws)]
    fperm = topology.ring_perm(ws, 1)
    bperm = topology.ring_perm(ws, -1)
    # reduce-scatter: ws-1 steps, both directions; K1 accumulates in
    # place into the rolled copy, which this function owns
    for s in range(ws - 1):
        for q in range(nq):
            f_in = axis.ppermute(fwd[(ws - s) % ws][q], fperm)
            b_in = axis.ppermute(bwd[s][q], bperm)
            f_dst = fwd[ws - 1 - s][q]
            b_dst = bwd[s + 1][q]
            combine(f_dst, f_in, out=f_dst)
            combine(b_dst, b_in, out=b_dst)
    # all-gather: ws-1 forwarding steps
    for t in range(ws - 1):
        for q in range(nq):
            f_in = axis.ppermute(fwd[(1 - t) % ws][q], fperm)
            b_in = axis.ppermute(bwd[(ws - 1 + t) % ws][q], bperm)
            fwd[(-t) % ws][q] = f_in
            bwd[t][q] = b_in
    out = torch.stack([torch.stack([torch.stack(row) for row in half])
                       for half in (fwd, bwd)])
    out = torch.roll(out, idx, dims=1)
    return out.reshape(-1)[:n].reshape(shape)


def _chunk_shard(x, ws: int):
    """Flatten + zero-pad into (ws, chunk) rows, always a fresh tensor
    (the schedules accumulate into it in place)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % ws
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    else:
        flat = flat.clone()
    return flat.reshape(ws, -1), (x.shape, x.numel())


def _unchunk_shard(chunks, meta):
    shape, size = meta
    return chunks.reshape(-1)[:size].reshape(shape)


def _ring_reduce_scatter(chunks, axis, op: str, use_kernel):
    """ws-1 steps; returns (owned_chunk_index, reduced_chunk). After the
    loop rank r owns the fully reduced chunk (r+1) mod ws. Accumulates in
    place into ``chunks``."""
    ws = chunks.shape[0]
    idx = axis.index
    combine = _combiner(op, use_kernel)
    perm = topology.ring_perm(ws)
    for s in range(ws - 1):
        recv = axis.ppermute(chunks[(idx - s) % ws], perm)
        cur = chunks[(idx - s - 1) % ws]
        combine(cur, recv, out=cur)
    own_idx = (idx + 1) % ws
    return own_idx, chunks[own_idx]


def _ring_all_gather_rolled(chunk, axis):
    """Rank r starts with chunk (r+1); ws-1 forwarding steps assemble the
    (ws, chunk) rows in index order on every rank."""
    ws, idx = axis.size, axis.index
    perm = topology.ring_perm(ws)
    out = chunk.new_zeros((ws,) + tuple(chunk.shape))
    out[(idx + 1) % ws] = chunk
    cur = chunk
    for s in range(ws - 1):
        cur = axis.ppermute(cur, perm)
        out[(idx - s) % ws] = cur
    return out


def _halving_reduce_scatter(chunks, axis, op: str, use_kernel):
    """Recursive halving (power-of-2 only): distances ws/2 .. 1, each
    round keeping the half of the range this rank's subtree owns and
    combining the partner's copy of it in. Rank r ends owning reduced
    chunk r."""
    ws = chunks.shape[0]
    idx = axis.index
    combine = _combiner(op, use_kernel)
    cur = chunks
    for s, dist in enumerate(topology.halving_doubling_distances(ws)):
        _hook(axis, "halving_reduce_scatter", s)
        upper = (idx & dist) != 0
        keep = cur[dist:2 * dist] if upper else cur[0:dist]
        send = cur[0:dist] if upper else cur[dist:2 * dist]
        recv = axis.ppermute(send, topology.xor_perm(ws, dist))
        cur = combine(keep, recv, out=keep)
    return cur[0]


def _doubling_all_gather(chunk, axis):
    """Recursive doubling (power-of-2 only): distances 1 .. ws/2, each
    round swapping the assembled block with rank XOR dist. Returns
    (ws, chunk) rows in index order."""
    ws, idx = axis.size, axis.index
    out = chunk.new_zeros((ws,) + tuple(chunk.shape))
    out[idx] = chunk
    for s, dist in enumerate(
            reversed(topology.halving_doubling_distances(ws))):
        _hook(axis, "doubling_all_gather", s)
        start = (idx // dist) * dist
        recv = axis.ppermute(out[start:start + dist],
                             topology.xor_perm(ws, dist))
        peer = start ^ dist
        out[peer:peer + dist] = recv
    return out


def _int8_gather_allreduce(x, axis):
    """Sum over a slow axis with int8 compression: per-rank symmetric
    quantisation (f32 scale = amax/127), all-gather of the int8 payload
    and the scales, f32 dequantise-and-sum. Error per element is at most
    one half-step per contributing rank. Sum only."""
    orig_dtype = x.dtype
    xf = x.float()
    amax = xf.abs().max()
    # XLA compiles the reference's "/ 127.0" into a product with the f32
    # reciprocal; the port does the same, so both quantise identically
    scale = torch.clamp_min(amax, 1e-30) * (1.0 / 127.0)
    q = torch.round(xf / scale).to(torch.int8)
    qs = axis.all_gather(q).double()
    ss = axis.all_gather(scale).double()
    # dequantise and sum in rank order with one rounding per rank, as
    # the fused multiply-adds XLA compiles the reference's sum into: an
    # int8 times an f32 is exact in f64, so each step rounds once
    acc = (qs[0] * ss[0]).float()
    for k in range(1, qs.shape[0]):
        acc = (acc.double() + qs[k] * ss[k]).float()
    return acc.to(orig_dtype)


def hierarchical_allreduce(x, ici_axis, dcn_axis, *, op: str = "sum",
                           ici_algorithm: str = "auto",
                           dcn_algorithm: str = "psum",
                           use_kernel: bool = True):
    """Allreduce over a 2-level (dcn x ici) mesh: reduce-scatter over
    ``ici_axis``, allreduce of the owned shard over ``dcn_axis`` (psum,
    a manual schedule, or 'int8'), all-gather over ``ici_axis``."""
    if dcn_algorithm == "int8" and op != "sum":
        raise ValueError("dcn_algorithm='int8' supports op='sum' only")
    _no_backward(x, "hierarchical_allreduce")
    wi = ici_axis.size
    chunks, meta = _chunk_shard(x, wi)
    pow2 = topology.is_power_of_2(wi)
    if pow2 and ici_algorithm in ("auto", "halving"):
        mine = _halving_reduce_scatter(chunks, ici_axis, op, use_kernel)
    else:
        _, reduced = _ring_reduce_scatter(chunks, ici_axis, op, use_kernel)
        mine = ici_axis.ppermute(reduced, topology.ring_perm(wi, 1))
    if dcn_axis.size > 1:
        if dcn_algorithm == "int8":
            mine = _int8_gather_allreduce(mine, dcn_axis)
        else:
            mine = allreduce(mine, dcn_axis, op=op, algorithm=dcn_algorithm,
                             use_kernel=use_kernel)
    gathered = _doubling_all_gather(mine, ici_axis) if pow2 \
        else all_gather(mine, ici_axis, algorithm="ring")
    return _unchunk_shard(gathered, meta)


def reduce_scatter(x, axis, *, op: str = "sum", algorithm: str = "auto",
                   use_kernel: bool = True):
    """Rank r gets the r-th equal chunk of the reduction of ``x``
    (flattened, zero-padded to a multiple of the axis size). algorithm:
    'ring', 'halving' (power-of-2), 'auto' (halving on powers of 2)."""
    ws = axis.size
    if algorithm == "auto":
        algorithm = "halving" if topology.is_power_of_2(ws) else "ring"
    chunks, _ = _chunk_shard(x, ws)
    if algorithm == "halving":
        return _halving_reduce_scatter(chunks, axis, op, use_kernel)
    if algorithm != "ring":
        raise ValueError(f"unknown algorithm {algorithm!r}")
    _, reduced = _ring_reduce_scatter(chunks, axis, op, use_kernel)
    # rotate one hop forward so rank r holds chunk r
    return axis.ppermute(reduced, topology.ring_perm(ws, 1))


def all_gather(x, axis, *, algorithm: str = "xla"):
    """Every rank's ``x`` along a new leading axis. 'xla' is the
    transport's own all-gather; 'ring' ws-1 steps; 'doubling' log2(ws)
    exchanges (power-of-2)."""
    if algorithm not in ("xla", "doubling", "ring"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if algorithm == "xla":
        return axis.all_gather(x)
    if algorithm == "doubling":
        return _doubling_all_gather(x, axis)
    ws, idx = axis.size, axis.index
    perm = topology.ring_perm(ws)
    out = x.new_zeros((ws,) + tuple(x.shape))
    out[idx] = x
    cur = x
    for s in range(ws - 1):
        cur = axis.ppermute(cur, perm)
        out[(idx - s - 1) % ws] = cur
    return out


def all_to_all(x, axis, *, algorithm: str = "xla"):
    """Rank r's row s (leading axis = axis size) goes to rank s at
    position r. 'xla' is the transport's own exchange; 'direct' ws-1
    shifted ppermutes of one chunk each; 'ring' rotates the whole buffer
    ws-1 steps (twice the link bytes of 'direct'). Differentiable under
    every schedule: the cotangent takes the inverse exchange."""
    ws = axis.size
    if x.shape[0] != ws:
        raise ValueError(f"leading axis {x.shape[0]} != axis size {ws}")
    if algorithm not in ("xla", "ring", "direct"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if algorithm == "xla":
        return autodiff.all_to_all(x, axis)
    idx = axis.index
    out = torch.zeros_like(x)
    out[idx] = x[idx]
    if algorithm == "direct":
        for o in range(1, ws):
            out[(idx - o) % ws] = autodiff.ppermute(
                x[(idx + o) % ws], axis, topology.ring_perm(ws, o))
        return out
    rolling = x
    perm = topology.ring_perm(ws)
    for s in range(ws - 1):
        rolling = autodiff.ppermute(rolling, axis, perm)
        out[(idx - s - 1) % ws] = rolling[idx]
    return out


def barrier(axis) -> torch.Tensor:
    """Synchronise every rank of ``axis`` (a sum of a unit token, as the
    JAX package does it); returns the int32 zero."""
    dev = getattr(axis, "device", None)
    return axis.all_reduce(torch.zeros((), dtype=torch.int32, device=dev),
                           "sum")


def consensus(vote: torch.Tensor, axis) -> torch.Tensor:
    """Leaderless decision: the AND of every rank's {0,1} vote, a min
    over int32 votes (the reference's ``vote &= v`` merge)."""
    return axis.all_reduce(vote.to(torch.int32), "min")
