"""ctypes bindings for the port's copy of the native C core.

Python surface mirrors rlo_tpu_torch.engine (ProgressEngine over the
loopback transport) so tests can run identical scenarios against both
implementations and compare outcomes. pybind11 is deliberately not used —
plain ctypes over the C ABI in rlo_core.h. The library is
``_build/librlo_torch_core.so`` (``build.py``), loaded ``RTLD_LOCAL`` under
its own name, so its globals (the trace ring, the world and comm tables)
stay apart from any other copy of the core in the same process.

A judge or action callback that raises inside the C core cannot unwind
through it: the trampoline keeps the exception, answers NO (a judge) or
nothing (an action), and the next call into the world or engine from
Python (progress, drain, submit, vote, pickup) raises it as
``CallbackError``.
"""

from __future__ import annotations

import ctypes as C
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from rlo_tpu_torch.native.build import build

# error codes (rlo_core.h enum rlo_err; -1 is the "nothing yet" sentinel)
OK = 0
ERR_ARG = -10
ERR_TOO_BIG = -11
ERR_BUSY = -12
ERR_PROTO = -13
ERR_NOMEM = -14
ERR_STALL = -15

# states (enum rlo_state)
COMPLETED = 0
IN_PROGRESS = 1
FAILED = 2
INVALID = 3

# spanning-tree shapes
FANOUT_SKIP_RING = 0  # rlo-lint: paired-with rlo_core.h:RLO_FANOUT_SKIP_RING
FANOUT_FLAT = 1  # rlo-lint: paired-with rlo_core.h:RLO_FANOUT_FLAT

from rlo_tpu_torch.utils.metrics import ENGINE_COUNTER_KEYS, ENGINE_PHASE_KEYS
from rlo_tpu_torch.wire import MSG_SIZE_MAX  # single shared engine-wide cap

_JUDGE_CB = C.CFUNCTYPE(C.c_int, C.POINTER(C.c_uint8), C.c_int64,
                        C.c_void_p)
_ACTION_CB = C.CFUNCTYPE(None, C.POINTER(C.c_uint8), C.c_int64, C.c_void_p)
# rlo_rank_fn (rlo_core.h): per-rank body run by the shm launcher
_RANK_FN = C.CFUNCTYPE(C.c_int, C.c_void_p, C.c_int, C.c_void_p)


class _EngineState(C.Structure):
    """Mirror of rlo_engine_state (rlo_core.h)."""
    _fields_ = [("rank", C.c_int32), ("world_size", C.c_int32),
                ("sent_bcast", C.c_int64), ("recved_bcast", C.c_int64),
                ("total_pickup", C.c_int64),
                ("prop_pid", C.c_int32), ("prop_state", C.c_int32),
                ("prop_vote", C.c_int32),
                ("prop_votes_needed", C.c_int32),
                ("prop_votes_recved", C.c_int32),
                ("gen_counter", C.c_int32),
                ("bcast_seq", C.c_int32)]


class _TraceEvent(C.Structure):
    """Mirror of rlo_trace_event (rlo_core.h)."""
    _fields_ = [("ts_usec", C.c_uint64), ("rank", C.c_int32),
                ("kind", C.c_int32), ("a", C.c_int32), ("b", C.c_int32),
                ("c", C.c_int32), ("d", C.c_int32)]


HIST_BUCKETS = 28  # mirror of RLO_HIST_BUCKETS (rlo_core.h)


class _Hist(C.Structure):
    """Mirror of rlo_hist (rlo_core.h) — same layout as the snapshot
    of rlo_tpu_torch.utils.metrics.Histogram."""
    _fields_ = [("count", C.c_int64), ("sum", C.c_double),
                ("min", C.c_double), ("max", C.c_double),
                ("buckets", C.c_int64 * HIST_BUCKETS)]

    def to_dict(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "buckets": list(self.buckets)}


class _LinkStats(C.Structure):
    """Mirror of rlo_link_stats (rlo_core.h)."""
    _fields_ = [("tx_frames", C.c_int64), ("tx_bytes", C.c_int64),
                ("rx_frames", C.c_int64), ("rx_bytes", C.c_int64),
                ("retransmits", C.c_int64), ("dup_drops", C.c_int64),
                ("rtt_ewma_usec", C.c_double)]

    def to_dict(self) -> dict:
        return {f: getattr(self, f) for f, _ in self._fields_}


class _PhaseStats(C.Structure):
    """Mirror of rlo_phase_stats (rlo_core.h) — the in-engine phase
    profiler's per-stage histograms; field order is the
    metrics.ENGINE_PHASE_KEYS snapshot order (rlo-lint R2 pins the
    pair)."""
    _fields_ = [("frame_encode", _Hist), ("frame_decode", _Hist),
                ("send", _Hist), ("arq_scan", _Hist),
                ("tag_dispatch", _Hist), ("pickup_drain", _Hist),
                ("bcast_first_fwd", _Hist),
                ("bcast_all_delivered", _Hist),
                ("prop_votes_aggregated", _Hist),
                ("prop_decision", _Hist)]


class _Stats(C.Structure):
    """Mirror of rlo_stats (rlo_core.h)."""
    _fields_ = [("sent_bcast", C.c_int64), ("recved_bcast", C.c_int64),
                ("total_pickup", C.c_int64), ("ops_failed", C.c_int64),
                ("arq_retransmits", C.c_int64),
                ("arq_dup_drops", C.c_int64),
                ("arq_gave_up", C.c_int64), ("arq_unacked", C.c_int64),
                ("epoch", C.c_int64), ("epoch_quarantined", C.c_int64),
                ("rejoins", C.c_int64),
                ("view_changes", C.c_int64),
                ("reflood_frames", C.c_int64),
                ("epoch_lag_max", C.c_int64),
                ("quar_mid_rejoin", C.c_int64),
                ("quar_failed_sender", C.c_int64),
                ("quar_below_floor", C.c_int64),
                ("admission_rounds", C.c_int64),
                ("epoch_syncs", C.c_int64),
                ("reflood_skipped", C.c_int64),
                ("batched_admits", C.c_int64),
                ("q_wait", C.c_int64), ("q_pickup", C.c_int64),
                ("q_wait_and_pickup", C.c_int64),
                ("q_iar_pending", C.c_int64),
                ("bcast_complete", _Hist), ("proposal_resolve", _Hist),
                ("pickup_wait", _Hist)]

_lib = None


class CallbackError(RuntimeError):
    """A judge or action callback raised inside the C core; the original
    exception is its ``__cause__``."""


def load() -> C.CDLL:
    """Build (if stale) and load the shared library, declaring signatures."""
    global _lib
    if _lib is not None:
        return _lib
    lib = C.CDLL(str(build()))

    def sig(name, restype, argtypes):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes

    p = C.c_void_p
    u8p = C.POINTER(C.c_uint8)
    sig("rlo_is_pow2", C.c_int, [C.c_int])
    sig("rlo_level", C.c_int, [C.c_int, C.c_int])
    sig("rlo_last_wall", C.c_int, [C.c_int, C.c_int])
    sig("rlo_send_list", C.c_int,
        [C.c_int, C.c_int, C.POINTER(C.c_int), C.c_int,
         C.POINTER(C.c_int)])
    sig("rlo_check_passed_origin", C.c_int,
        [C.c_int, C.c_int, C.c_int, C.c_int])
    sig("rlo_fwd_targets", C.c_int,
        [C.c_int, C.c_int, C.c_int, C.c_int, C.POINTER(C.c_int), C.c_int])
    sig("rlo_fwd_send_cnt", C.c_int, [C.c_int, C.c_int, C.c_int, C.c_int])
    sig("rlo_initiator_targets", C.c_int,
        [C.c_int, C.c_int, C.POINTER(C.c_int), C.c_int])
    sig("rlo_frame_encode", C.c_int64,
        [u8p, C.c_int64, C.c_int32, C.c_int32, C.c_int32, C.c_int32,
         u8p, C.c_int64])
    sig("rlo_frame_decode", C.c_int64,
        [u8p, C.c_int64, C.POINTER(C.c_int32), C.POINTER(C.c_int32),
         C.POINTER(C.c_int32), C.POINTER(C.c_int32), C.POINTER(u8p)])
    sig("rlo_frame_epoch", C.c_int32, [u8p])
    sig("rlo_frame_set_epoch", None, [u8p, C.c_int32])
    sig("rlo_world_new", p, [C.c_int, C.c_int, C.c_uint64])
    sig("rlo_world_free", None, [p])
    sig("rlo_world_size", C.c_int, [p])
    sig("rlo_world_my_rank", C.c_int, [p])
    sig("rlo_world_transport", C.c_char_p, [p])
    sig("rlo_world_failed", C.c_int, [p])
    sig("rlo_world_peer_alive", C.c_int, [p, C.c_int, C.c_uint64])
    sig("rlo_world_kill_rank", C.c_int, [p, C.c_int])
    sig("rlo_world_drop_next", C.c_int, [p, C.c_int, C.c_int, C.c_int])
    sig("rlo_world_dup_next", C.c_int, [p, C.c_int, C.c_int, C.c_int])
    sig("rlo_engine_enable_arq", C.c_int, [p, C.c_uint64, C.c_int])
    sig("rlo_engine_arq_retransmits", C.c_int64, [p])
    sig("rlo_engine_arq_dup_drops", C.c_int64, [p])
    sig("rlo_engine_arq_unacked", C.c_int64, [p])
    sig("rlo_engine_arq_gave_up", C.c_int64, [p])
    sig("rlo_engine_enable_metrics", C.c_int, [p, C.c_int])
    sig("rlo_engine_stats", C.c_int, [p, C.POINTER(_Stats)])
    sig("rlo_engine_enable_profiler", C.c_int, [p, C.c_int])
    sig("rlo_engine_phase_stats", C.c_int, [p, C.POINTER(_PhaseStats)])
    # telemetry digest codec + engine origination (docs/DESIGN.md §17)
    sig("rlo_telem_encode", C.c_int64,
        [u8p, C.c_int64, C.c_int32, C.c_int32, C.c_uint32, C.c_int,
         C.POINTER(C.c_int64), C.POINTER(C.c_int64)])
    sig("rlo_telem_decode", C.c_int64,
        [u8p, C.c_int64, C.POINTER(C.c_int32), C.POINTER(C.c_int32),
         C.POINTER(C.c_uint32), C.POINTER(C.c_int), C.POINTER(C.c_int64),
         C.POINTER(C.c_uint64)])
    sig("rlo_telem_key_name", C.c_char_p, [C.c_int])
    # span context codec (docs/DESIGN.md §19)
    sig("rlo_span_encode", C.c_int64,
        [u8p, C.c_int64, C.c_int32, C.c_int32, C.c_int, C.c_int,
         C.c_uint64])
    sig("rlo_span_decode", C.c_int64,
        [u8p, C.c_int64, C.POINTER(C.c_int32), C.POINTER(C.c_int32),
         C.POINTER(C.c_int), C.POINTER(C.c_int), C.POINTER(C.c_uint64)])
    sig("rlo_engine_telem_digest", C.c_int64, [p, C.c_int, u8p, C.c_int64])
    sig("rlo_engine_link_stats", C.c_int,
        [p, C.POINTER(_LinkStats), C.c_int])
    sig("rlo_engine_enable_failure_detection", C.c_int,
        [p, C.c_uint64, C.c_uint64])
    sig("rlo_engine_rank_failed", C.c_int, [p, C.c_int])
    sig("rlo_engine_failed_count", C.c_int, [p])
    sig("rlo_engine_suspected_self", C.c_int, [p])
    sig("rlo_world_partition", C.c_int, [p, C.POINTER(C.c_int), C.c_int])
    sig("rlo_world_revive_rank", C.c_int, [p, C.c_int])
    sig("rlo_engine_set_incarnation", C.c_int, [p, C.c_int])
    sig("rlo_engine_rejoin", C.c_int, [p])
    sig("rlo_engine_epoch", C.c_int64, [p])
    sig("rlo_engine_epoch_quarantined", C.c_int64, [p])
    sig("rlo_engine_rejoins", C.c_int64, [p])
    sig("rlo_engine_awaiting_welcome", C.c_int, [p])
    sig("rlo_engine_state_get", C.c_int, [p, C.POINTER(_EngineState)])
    sig("rlo_engine_state_set", C.c_int, [p, C.POINTER(_EngineState)])
    sig("rlo_engine_set_fanout", C.c_int, [p, C.c_int])
    sig("rlo_shm_launch", C.c_int, [C.c_int, C.c_int64, _RANK_FN, p])
    sig("rlo_shm_barrier", None, [p])
    sig("rlo_mpi_available", C.c_int, [])
    sig("rlo_mpi_world_new", p, [])
    sig("rlo_tcp_available", C.c_int, [])
    sig("rlo_tcp_world_new", p, [])
    sig("rlo_world_quiescent", C.c_int, [p])
    sig("rlo_world_sent_cnt", C.c_int64, [p])
    sig("rlo_world_delivered_cnt", C.c_int64, [p])
    # the batched drivers run for the call's whole duration with the
    # GIL released — rlo-sentinel S1 roots its per-world-ownership
    # call-graph scan here (docs/DESIGN.md §15)
    sig("rlo_engine_progress_n", C.c_int64,  # rlo-sentinel: gil-released
        [p, C.c_int64, C.c_uint64])
    sig("rlo_world_progress_all_n", C.c_int64,  # rlo-sentinel: gil-released
        [p, C.c_int64, C.c_uint64])
    sig("rlo_engine_frames_dispatched", C.c_int64, [p])
    sig("rlo_engine_arq_heap_len", C.c_int64, [p])
    sig("rlo_engine_arq_scan_gated", C.c_int64, [p])
    sig("rlo_engine_new", p,
        [p, C.c_int, C.c_int, _JUDGE_CB, p, _ACTION_CB, p, C.c_int64])
    sig("rlo_engine_new_sub", p,
        [p, C.c_int, C.c_int, C.POINTER(C.c_int), C.c_int, _JUDGE_CB, p,
         _ACTION_CB, p, C.c_int64])
    sig("rlo_engine_free", None, [p])
    sig("rlo_progress_all", None, [p])
    sig("rlo_bcast", C.c_int, [p, u8p, C.c_int64])
    sig("rlo_submit_proposal", C.c_int, [p, u8p, C.c_int64, C.c_int])
    sig("rlo_check_proposal_state", C.c_int, [p])
    sig("rlo_vote_my_proposal", C.c_int, [p])
    sig("rlo_proposal_reset", None, [p])
    sig("rlo_pickup_next", C.c_int64,
        [p, C.POINTER(C.c_int), C.POINTER(C.c_int), C.POINTER(C.c_int),
         C.POINTER(C.c_int), u8p, C.c_int64])
    sig("rlo_pickup_peek", C.c_int64,
        [p, C.POINTER(C.c_int), C.POINTER(C.c_int), C.POINTER(C.c_int),
         C.POINTER(C.c_int), C.POINTER(C.POINTER(C.c_uint8))])
    sig("rlo_pickup_consume", C.c_int, [p])
    sig("rlo_bench_allreduce", C.c_double, [C.c_int, C.c_int64, C.c_int])
    sig("rlo_bench_allreduce_ring", C.c_double,
        [C.c_int, C.c_int64, C.c_int])
    sig("rlo_bench_bcast_usec", C.c_double, [C.c_int, C.c_int64, C.c_int])
    sig("rlo_coll_new", p, [p, C.c_int, C.c_int])
    sig("rlo_coll_new_sub", p,
        [p, C.c_int, C.c_int, C.POINTER(C.c_int), C.c_int])
    sig("rlo_coll_free", None, [p])
    fp = C.POINTER(C.c_float)
    sig("rlo_coll_allreduce_f32_start", C.c_int,
        [p, fp, C.c_int64, C.c_int])
    sig("rlo_coll_reduce_scatter_f32_start", C.c_int,
        [p, fp, C.c_int64, fp, C.c_int])
    sig("rlo_coll_all_gather_start", C.c_int, [p, u8p, C.c_int64, u8p])
    sig("rlo_coll_all_to_all_start", C.c_int, [p, u8p, C.c_int64, u8p])
    sig("rlo_coll_barrier_start", C.c_int, [p])
    sig("rlo_coll_poll", C.c_int, [p])
    sig("rlo_coll_wait", C.c_int, [p, C.c_long])
    sig("rlo_engine_idle", C.c_int, [p])
    sig("rlo_engine_err", C.c_int, [p])
    sig("rlo_engine_total_pickup", C.c_int64, [p])
    sig("rlo_engine_sent_bcast", C.c_int64, [p])
    sig("rlo_engine_recved_bcast", C.c_int64, [p])
    sig("rlo_drain", C.c_int, [p, C.c_int])
    sig("rlo_world_barrier", None, [p])
    sig("rlo_world_inject", C.c_int,
        [p, C.c_int, C.c_int, C.c_int, C.c_int, u8p, C.c_int64])
    sig("rlo_now_usec", C.c_uint64, [])
    sig("rlo_trace_set", None, [C.c_int])
    sig("rlo_trace_enabled", C.c_int, [])
    sig("rlo_trace_emit", None, [C.c_int] * 6)
    sig("rlo_trace_drain", C.c_int, [C.POINTER(_TraceEvent), C.c_int])
    sig("rlo_trace_dropped", C.c_int64, [])
    sig("rlo_trace_capacity", C.c_int, [])
    sig("rlo_trace_clear", None, [])
    _lib = lib
    return lib


def _buf(data: bytes):
    return (C.c_uint8 * len(data)).from_buffer_copy(data) if data else None


@dataclass
class NativeUserMsg:
    """Mirror of rlo_tpu_torch.engine.UserMsg for cross-implementation
    tests."""
    type: int
    origin: int
    pid: int = -1
    vote: int = -1
    data: bytes = b""


class NativeWorld:
    """Owns an rlo_world (in-process loopback transport)."""

    def __init__(self, world_size: int, latency: int = 0, seed: int = 1):
        self._lib = load()
        self._w = self._lib.rlo_world_new(world_size, latency, seed)
        if not self._w:
            raise ValueError(f"world_size must be >= 2, got {world_size}")
        self.world_size = world_size
        self.engines: List["NativeEngine"] = []
        #: NativeColl instances bound to this world — closed before the
        #: world is freed (pooled objects must never outlive the world
        #: that owns their freelists, rlo_internal.h pool rules)
        self.colls: List["NativeColl"] = []
        #: exceptions raised by callbacks inside C, raised on return
        self._cb_errors: List[BaseException] = []

    @classmethod
    def adopt(cls, lib, w) -> "NativeWorld":
        """Wrap a per-rank C world made elsewhere (MPI, TCP) so engines,
        collectives and drain work on it unchanged."""
        self = cls.__new__(cls)
        self._lib = lib
        self._w = w
        self.world_size = lib.rlo_world_size(w)
        self.engines = []
        self.colls = []
        self._cb_errors = []
        return self

    def raise_callback_error(self) -> None:
        """Raise the first exception a callback kept since the last
        check (see the module docstring)."""
        if self._cb_errors:
            err, self._cb_errors[:] = self._cb_errors[0], []
            raise CallbackError(
                f"a callback raised inside the C core: {err!r}") from err

    def progress_all(self) -> None:
        self._lib.rlo_progress_all(self._w)
        self.raise_callback_error()

    def progress_n(self, max_frames: int = 0,
                   deadline_usec: int = 0) -> int:
        """Batched progress (docs/DESIGN.md §13): loop progress sweeps
        INSIDE C until ``max_frames`` frames were processed (0 = no
        budget), ``deadline_usec`` microseconds elapsed (0 = no
        deadline), or — with no deadline — the first fruitless sweep
        with a quiescent transport. Returns frames processed. ctypes
        releases the GIL for the call's whole duration, so one Python
        crossing progresses thousands of frames (and with a deadline
        the call is a GIL-released poll-wait — the serving-pump
        shape). Re-entrant calls (from a judge/action callback) are
        no-ops returning 0."""
        rc = self._lib.rlo_world_progress_all_n(
            self._w, max_frames, deadline_usec)
        self.raise_callback_error()
        if rc < 0:
            raise RuntimeError(f"progress_n failed ({rc})")
        return rc

    def quiescent(self) -> bool:
        return bool(self._lib.rlo_world_quiescent(self._w))

    def failed(self) -> bool:
        """True when the world is dead — a peer process crashed (shm
        abort flag / tcp reset or mid-frame EOF). A graceful peer
        departure does NOT set it."""
        return bool(self._lib.rlo_world_failed(self._w))

    def peer_alive(self, rank: int, timeout_usec: int = 1_000_000) -> bool:
        """Net-new failure detection (SURVEY.md §5), transport-
        specific: shm = False when `rank` stamped no heartbeat slot
        for timeout_usec; tcp = False when `rank`'s connection is
        closed (graceful exit or crash — timeout_usec is ignored, and
        a hung-but-connected peer stays True: that is the engine-level
        heartbeat detector's job). Always True on transports without
        a liveness signal (in-process loopback)."""
        return bool(self._lib.rlo_world_peer_alive(self._w, rank,
                                                   timeout_usec))

    def kill_rank(self, rank: int) -> None:
        """Fault injection (loopback only): simulate `rank` crashing —
        mirror of LoopbackWorld.kill_rank."""
        rc = self._lib.rlo_world_kill_rank(self._w, rank)
        if rc != 0:
            raise RuntimeError(f"kill_rank failed ({rc})")

    def drop_next(self, src: int, dst: int, count: int = 1) -> None:
        """Fault injection (loopback only): silently drop the next
        ``count`` frames src -> dst — mirror of
        LoopbackWorld.drop_next."""
        rc = self._lib.rlo_world_drop_next(self._w, src, dst, count)
        if rc != 0:
            raise RuntimeError(f"drop_next failed ({rc})")

    def dup_next(self, src: int, dst: int, count: int = 1) -> None:
        """Fault injection (loopback only): deliver the next ``count``
        frames src -> dst twice — mirror of LoopbackWorld.dup_next."""
        rc = self._lib.rlo_world_dup_next(self._w, src, dst, count)
        if rc != 0:
            raise RuntimeError(f"dup_next failed ({rc})")

    def partition(self, groups) -> None:
        """Fault injection (loopback only): split the network into
        ``groups`` (sequences of ranks) — frames crossing the cut are
        dropped, including frames already in flight across it. Ranks
        not named fall into singleton groups. Mirror of
        SimWorld.partition."""
        gmap = {}
        for gi, g in enumerate(groups):
            for r in g:
                if not 0 <= r < self.world_size:
                    raise ValueError(f"bad rank {r} in partition")
                if r in gmap:
                    raise ValueError(f"rank {r} in two groups")
                gmap[r] = gi
        arr = (C.c_int * self.world_size)(
            *[gmap.get(r, len(groups) + r)
              for r in range(self.world_size)])
        rc = self._lib.rlo_world_partition(self._w, arr,
                                           self.world_size)
        if rc != 0:
            raise RuntimeError(f"partition failed ({rc})")

    def heal(self) -> None:
        """Remove the partition; traffic flows everywhere again."""
        rc = self._lib.rlo_world_partition(
            self._w, C.cast(None, C.POINTER(C.c_int)), 0)
        if rc != 0:
            raise RuntimeError(f"heal failed ({rc})")

    def revive_rank(self, rank: int) -> None:
        """Revive a killed rank's endpoint with an empty inbox (build a
        fresh engine with a bumped incarnation on top — mirror of
        SimWorld.restart_rank)."""
        rc = self._lib.rlo_world_revive_rank(self._w, rank)
        if rc != 0:
            raise RuntimeError(f"revive_rank failed ({rc})")

    @property
    def sent_cnt(self) -> int:
        return self._lib.rlo_world_sent_cnt(self._w)

    @property
    def delivered_cnt(self) -> int:
        return self._lib.rlo_world_delivered_cnt(self._w)

    def barrier(self) -> None:
        """Collective barrier across ranks (shm/mpi; no-op loopback)."""
        self._lib.rlo_world_barrier(self._w)

    def inject(self, src: int, dst: int, tag: int, raw: bytes,
               comm: int = 0) -> None:
        """Test support: place one raw frame on the (src, dst) channel
        as if src had sent it (duplicate/stale-frame scenarios)."""
        buf = (C.c_uint8 * len(raw)).from_buffer_copy(raw)
        rc = self._lib.rlo_world_inject(self._w, src, dst, comm, tag,
                                        buf, len(raw))
        if rc != 0:
            raise RuntimeError(f"inject failed ({rc})")

    def drain(self, max_spins: int = 100_000) -> int:
        rc = self._lib.rlo_drain(self._w, max_spins)
        self.raise_callback_error()
        if rc == ERR_STALL:
            raise RuntimeError("native drain did not reach quiescence")
        return rc

    def close(self) -> None:
        for e in list(self.engines):
            e.close()
        for c in list(getattr(self, "colls", [])):
            c.close()
        if self._w:
            self._lib.rlo_world_free(self._w)
            self._w = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_COLL_OPS = {"sum": 0, "min": 1, "max": 2}


class NativeColl:
    """Engine-substrate ring data collectives (rlo_coll.c) — the C
    mirror of rlo_tpu_torch/ops/collectives.py's coroutine Comm. Each op is a
    start/poll state machine; `blocking=True` helpers spin to
    completion (one-process-per-rank worlds), while in-process drivers
    round-robin `poll()` across ranks like run_collectives()."""

    MAX_SPINS = 200_000_000

    def __init__(self, world: "NativeWorld", rank: int, comm: int = 64,
                 members: Optional[List[int]] = None):
        """``members`` scopes the collectives to a rank subset (the
        data-collective face of sub-communicators); slot layouts are
        indexed by subset position."""
        self._lib = world._lib
        self.world = world
        self.rank = rank
        self.comm = comm  # must differ from every engine comm
        if members is None:
            self._c = self._lib.rlo_coll_new(world._w, rank, comm)
            self.group_size = world.world_size
            if not self._c:
                raise ValueError(f"bad rank {rank} for this world")
        else:
            ms = sorted(set(members))
            arr = (C.c_int * len(ms))(*ms)
            self._c = self._lib.rlo_coll_new_sub(world._w, rank, comm,
                                                 arr, len(ms))
            self.group_size = len(ms)
            if not self._c:
                raise ValueError(
                    f"bad subset for rank {rank}: members={ms} (need "
                    f"2..64 in-range members including this rank)")
        getattr(world, "colls", []).append(self)
        self._keep = None  # buffers pinned while an op is in flight

    def close(self) -> None:
        if self._c:
            self._lib.rlo_coll_free(self._c)
            self._c = None
        colls = getattr(self.world, "colls", None)
        if colls is not None and self in colls:
            colls.remove(self)

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def poll(self) -> int:
        """1 done, 0 in progress (<0 raises)."""
        rc = self._lib.rlo_coll_poll(self._c)
        if rc < 0 and rc != -1:  # -1 RLO_ERR_ARG = nothing armed
            raise RuntimeError(f"coll poll failed ({rc})")
        return rc

    def _wait(self):
        rc = self._lib.rlo_coll_wait(self._c, self.MAX_SPINS)
        if rc != 0:
            raise RuntimeError(f"collective did not complete ({rc})")

    # -- fp32 ring ops -------------------------------------------------
    def allreduce_start(self, x: "np.ndarray", op: str = "sum"):
        """Arm an in-place ring allreduce; returns the output array
        (filled when poll() reports done)."""
        buf = np.ascontiguousarray(x, np.float32).reshape(-1).copy()
        rc = self._lib.rlo_coll_allreduce_f32_start(
            self._c, buf.ctypes.data_as(C.POINTER(C.c_float)), buf.size,
            _COLL_OPS[op])
        if rc != 0:
            raise RuntimeError(f"allreduce start failed ({rc})")
        self._keep = (buf,)
        return buf

    def allreduce(self, x: "np.ndarray", op: str = "sum"):
        out = self.allreduce_start(x, op)
        self._wait()
        return out.reshape(np.asarray(x).shape)

    def reduce_scatter_start(self, x: "np.ndarray", op: str = "sum"):
        buf = np.ascontiguousarray(x, np.float32).reshape(-1).copy()
        ws = self.group_size
        chunk = -(-buf.size // ws)
        out = np.empty(chunk, np.float32)
        rc = self._lib.rlo_coll_reduce_scatter_f32_start(
            self._c, buf.ctypes.data_as(C.POINTER(C.c_float)), buf.size,
            out.ctypes.data_as(C.POINTER(C.c_float)), _COLL_OPS[op])
        if rc != 0:
            raise RuntimeError(f"reduce_scatter start failed ({rc})")
        self._keep = (buf, out)
        return out

    def reduce_scatter(self, x, op: str = "sum"):
        out = self.reduce_scatter_start(x, op)
        self._wait()
        return out

    # -- byte ops ------------------------------------------------------
    def all_gather_start(self, data: bytes):
        ws = self.group_size
        src = np.frombuffer(bytes(data), np.uint8).copy()
        out = np.empty(ws * len(data), np.uint8)
        rc = self._lib.rlo_coll_all_gather_start(
            self._c, src.ctypes.data_as(C.POINTER(C.c_uint8)), len(data),
            out.ctypes.data_as(C.POINTER(C.c_uint8)))
        if rc != 0:
            raise RuntimeError(f"all_gather start failed ({rc})")
        self._keep = (src, out)
        return out

    def all_gather(self, data: bytes):
        """Returns [bytes per rank]."""
        out = self.all_gather_start(data)
        self._wait()
        n = len(out) // self.group_size
        raw = out.tobytes()
        return [raw[i * n:(i + 1) * n]
                for i in range(self.group_size)]

    def all_to_all_start(self, chunks):
        ws = self.group_size
        if len(chunks) != ws:
            raise ValueError(f"need {ws} chunks, got {len(chunks)}")
        n = len(chunks[0])
        if any(len(ch) != n for ch in chunks):
            raise ValueError("all chunks must be equal-sized")
        src = np.frombuffer(b"".join(bytes(ch) for ch in chunks),
                            np.uint8).copy()
        out = np.empty(ws * n, np.uint8)
        rc = self._lib.rlo_coll_all_to_all_start(
            self._c, src.ctypes.data_as(C.POINTER(C.c_uint8)), n,
            out.ctypes.data_as(C.POINTER(C.c_uint8)))
        if rc != 0:
            raise RuntimeError(f"all_to_all start failed ({rc})")
        self._keep = (src, out)
        return out

    def all_to_all(self, chunks):
        out = self.all_to_all_start(chunks)
        self._wait()
        ws = self.group_size
        n = len(out) // ws
        raw = out.tobytes()
        return [raw[i * n:(i + 1) * n] for i in range(ws)]

    def barrier_start(self):
        rc = self._lib.rlo_coll_barrier_start(self._c)
        if rc != 0:
            raise RuntimeError(f"barrier start failed ({rc})")

    def barrier(self):
        self.barrier_start()
        self._wait()


def run_colls(colls, starts, max_spins: int = 10_000_000):
    """Round-robin driver for in-process worlds: `starts[i]()` arms
    rank i's op, then every coll is polled until all complete — the C
    mirror of collectives.run_collectives()."""
    outs = [start() for start in starts]
    alive = set(range(len(colls)))
    for _ in range(max_spins):
        for i in list(alive):
            if colls[i].poll() == 1:
                alive.discard(i)
        if not alive:
            return outs
    raise RuntimeError("collective did not complete (deadlock?)")


class NativeEngine:
    """One rank's progress engine in a NativeWorld."""

    def __init__(self, world: NativeWorld, rank: int, comm: int = 0,
                 judge_cb: Optional[Callable[[bytes, object], int]] = None,
                 app_ctx: object = None,
                 action_cb: Optional[Callable[[bytes, object], None]] = None,
                 msg_size_max: int = MSG_SIZE_MAX,
                 members: Optional[List[int]] = None):
        """``members`` builds the engine over a rank subset (a
        sub-communicator: rlo_engine_new_sub; give it a distinct
        ``comm`` from any full-world engine on the same world)."""
        self._lib = load()
        self.world = world
        self.rank = rank
        self.world_size = world.world_size
        self.msg_size_max = msg_size_max
        self.app_ctx = app_ctx
        self.members = sorted(set(members)) if members is not None \
            else None

        # keep CFUNCTYPE wrappers alive for the engine's lifetime
        errors = world._cb_errors

        def payload(buf, n) -> bytes:
            return bytes(C.cast(buf, C.POINTER(C.c_uint8 * n)).contents) \
                if n else b""

        def judge(buf, n, _ctx) -> int:
            try:
                return int(judge_cb(payload(buf, n), app_ctx))
            except BaseException as e:  # cannot unwind through C
                errors.append(e)
                return 0

        def action(buf, n, _ctx) -> None:
            try:
                action_cb(payload(buf, n), app_ctx)
            except BaseException as e:
                errors.append(e)

        self._judge = _JUDGE_CB(judge) if judge_cb is not None \
            else C.cast(None, _JUDGE_CB)
        self._action = _ACTION_CB(action) if action_cb is not None \
            else C.cast(None, _ACTION_CB)

        if self.members is None:
            self._e = self._lib.rlo_engine_new(
                world._w, rank, comm, self._judge, None, self._action,
                None, msg_size_max)
        else:
            arr = (C.c_int * len(self.members))(*self.members)
            self._e = self._lib.rlo_engine_new_sub(
                world._w, rank, comm, arr, len(self.members),
                self._judge, None, self._action, None, msg_size_max)
        if not self._e:
            raise RuntimeError(f"engine creation failed (rank {rank})")
        world.engines.append(self)

    def _check(self, rc: int) -> int:
        if rc == ERR_BUSY:
            raise RuntimeError("proposal still in progress")
        if rc == ERR_TOO_BIG:
            raise ValueError("payload exceeds msg_size_max")
        if rc in (ERR_ARG, ERR_PROTO, ERR_NOMEM):
            raise RuntimeError(f"native error {rc}")
        return rc

    def bcast(self, payload: bytes) -> None:
        self._check(self._lib.rlo_bcast(
            self._e, _buf(payload), len(payload)))

    def submit_proposal(self, proposal: bytes, pid: int) -> int:
        rc = self._lib.rlo_submit_proposal(
            self._e, _buf(proposal), len(proposal), pid)
        self.world.raise_callback_error()
        return self._check(rc)

    def check_proposal_state(self) -> int:
        return self._lib.rlo_check_proposal_state(self._e)

    def vote_my_proposal(self) -> int:
        rc = self._lib.rlo_vote_my_proposal(self._e)
        self.world.raise_callback_error()
        return rc

    def proposal_reset(self) -> None:
        self._lib.rlo_proposal_reset(self._e)

    def pickup_next(self) -> Optional[NativeUserMsg]:
        # zero-copy peek + consume: the single copy is string_at pulling
        # the payload out of the engine-owned frame blob into a Python
        # bytes (the engine's buffer is only valid until the next call)
        tag = C.c_int()
        origin = C.c_int()
        pid = C.c_int()
        vote = C.c_int()
        payload = C.POINTER(C.c_uint8)()
        n = self._lib.rlo_pickup_peek(
            self._e, C.byref(tag), C.byref(origin), C.byref(pid),
            C.byref(vote), C.byref(payload))
        self.world.raise_callback_error()
        if n < 0:
            if n == -1:
                return None
            self._check(int(n))
        data = C.string_at(payload, int(n)) if n else b""
        self._check(self._lib.rlo_pickup_consume(self._e))
        return NativeUserMsg(type=tag.value, origin=origin.value,
                             pid=pid.value, vote=vote.value, data=data)

    def progress(self, max_frames: int = 0,
                 deadline_usec: int = 0) -> int:
        """Batched single-engine progress (docs/DESIGN.md §13): loop
        THIS engine's progress turns inside C until the budget fills,
        the deadline expires, or — with no deadline — the first
        fruitless turn (it never spins on other engines' traffic, so
        one-frame-at-a-time stepping is ``progress(max_frames=1)``).
        Returns frames processed; the GIL is released throughout."""
        rc = self._lib.rlo_engine_progress_n(
            self._e, max_frames, deadline_usec)
        self.world.raise_callback_error()
        if rc < 0:
            raise RuntimeError(f"progress failed ({rc})")
        return rc

    @property
    def frames_dispatched(self) -> int:
        """Lifetime frames this engine polled off the transport (every
        polled frame counts: ACKs, heartbeats, duplicates)."""
        return self._lib.rlo_engine_frames_dispatched(self._e)

    @property
    def arq_heap_len(self) -> int:
        """Live population of the lazy ARQ due-heap (stale entries for
        acked frames linger until their deadline pops them)."""
        return self._lib.rlo_engine_arq_heap_len(self._e)

    @property
    def arq_scan_gated(self) -> int:
        """Retransmit sweeps skipped on the O(1) due-heap peek."""
        return self._lib.rlo_engine_arq_scan_gated(self._e)

    def enable_failure_detection(self, timeout_usec: int,
                                 interval_usec: int = 0) -> None:
        """Ring-heartbeat liveness detection + elastic survivor
        re-forming (mirror of ProgressEngine's failure_timeout)."""
        rc = self._lib.rlo_engine_enable_failure_detection(
            self._e, timeout_usec, interval_usec)
        if rc != 0:
            raise RuntimeError(f"enable_failure_detection failed ({rc})")

    def enable_arq(self, rto_usec: int, max_retries: int = 8) -> None:
        """Reliable delivery: per-(src, dst) link seqs, retransmit
        until acked with exponential backoff, receive-side dedup
        (mirror of ProgressEngine's arq_rto machinery)."""
        rc = self._lib.rlo_engine_enable_arq(self._e, rto_usec,
                                             max_retries)
        if rc != 0:
            raise RuntimeError(f"enable_arq failed ({rc})")

    @property
    def arq_retransmits(self) -> int:
        return self._lib.rlo_engine_arq_retransmits(self._e)

    @property
    def arq_dup_drops(self) -> int:
        return self._lib.rlo_engine_arq_dup_drops(self._e)

    @property
    def arq_unacked(self) -> int:
        return self._lib.rlo_engine_arq_unacked(self._e)

    @property
    def arq_gave_up(self) -> int:
        return self._lib.rlo_engine_arq_gave_up(self._e)

    def enable_metrics(self, on: bool = True) -> None:
        """Per-link frame/byte/RTT accounting + op-latency histograms
        (mirror of ProgressEngine.enable_metrics; one branch per
        send/receive when off)."""
        rc = self._lib.rlo_engine_enable_metrics(self._e, 1 if on else 0)
        if rc != 0:
            raise RuntimeError(f"enable_metrics failed ({rc})")

    def enable_profiler(self, on: bool = True) -> None:
        """In-engine phase profiler (docs/DESIGN.md §10): per-stage
        duration histograms over the ENGINE_PHASE_KEYS taxonomy
        (mirror of ProgressEngine.enable_profiler; one branch per
        instrumented site when off)."""
        rc = self._lib.rlo_engine_enable_profiler(self._e,
                                                  1 if on else 0)
        if rc != 0:
            raise RuntimeError(f"enable_profiler failed ({rc})")

    def metrics(self) -> dict:
        """Drain rlo_engine_stats / rlo_engine_link_stats into the
        SAME nested-dict schema as ProgressEngine.metrics() — counter
        keys, nesting, and histogram layout are identical by
        construction (asserted by the metrics-parity test)."""
        st = _Stats()
        rc = self._lib.rlo_engine_stats(self._e, C.byref(st))
        if rc != 0:
            raise RuntimeError(f"rlo_engine_stats failed ({rc})")
        ws = self.world_size
        arr = (_LinkStats * ws)()
        rc = self._lib.rlo_engine_link_stats(self._e, arr, ws)
        if rc < 0:
            raise RuntimeError(f"rlo_engine_link_stats failed ({rc})")
        ph = _PhaseStats()
        rc = self._lib.rlo_engine_phase_stats(self._e, C.byref(ph))
        if rc != 0:
            raise RuntimeError(f"rlo_engine_phase_stats failed ({rc})")
        return {
            # ENGINE_COUNTER_KEYS is the schema contract with the
            # Python engine (ProgressEngine.metrics builds from the
            # same tuple; the parity test asserts dict equality)
            "counters": {k: getattr(st, k)
                         for k in ENGINE_COUNTER_KEYS},
            "queues": {
                "wait": st.q_wait,
                "pickup": st.q_pickup,
                "wait_and_pickup": st.q_wait_and_pickup,
                "iar_pending": st.q_iar_pending,
            },
            # string peer keys: identical schema in memory and through
            # a JSON round-trip (mirror of ProgressEngine.metrics())
            "links": {str(peer): arr[peer].to_dict()
                      for peer in range(ws) if peer != self.rank},
            "op_latency_usec": {
                "bcast_complete": st.bcast_complete.to_dict(),
                "proposal_resolve": st.proposal_resolve.to_dict(),
                "pickup_wait": st.pickup_wait.to_dict(),
            },
            # ENGINE_PHASE_KEYS doubles as the rlo_phase_stats field
            # order (rlo-lint R2), so the same tuple drives both
            # engines' "phases" assembly
            "phases": {k: getattr(ph, k).to_dict()
                       for k in ENGINE_PHASE_KEYS},
        }

    def telem_digest(self, full: bool = False) -> bytes:
        """Originate one telemetry digest from the C engine's own
        telemetry (docs/DESIGN.md §17): delta-encoded vs the last
        digest this engine emitted, first call always a full
        snapshot. The bytes are a Tag.TELEM frame payload the
        telemetry plane (rlo_tpu_torch/observe/) decodes and merges like
        any Python-originated digest."""
        from rlo_tpu_torch.wire import TELEM_HEADER_SIZE, TELEM_KEYS
        cap = TELEM_HEADER_SIZE + 10 * len(TELEM_KEYS)
        buf = (C.c_uint8 * cap)()
        n = self._lib.rlo_engine_telem_digest(
            self._e, 1 if full else 0, buf, cap)
        if n < 0:
            raise RuntimeError(f"rlo_engine_telem_digest failed ({n})")
        return bytes(buf[:n])

    def set_fanout(self, mode: int) -> None:
        """Select the bcast/IAR spanning-tree shape (FANOUT_SKIP_RING /
        FANOUT_FLAT, rlo_core.h RLO_FANOUT_*) — only while the engine
        is idle between rounds; mirror of ProgressEngine(fanout=)."""
        rc = self._lib.rlo_engine_set_fanout(self._e, mode)
        if rc != 0:
            raise ValueError(f"set_fanout({mode}) failed ({rc}): bad "
                             f"mode or engine mid-round")

    def set_incarnation(self, incarnation: int) -> None:
        """Partition this engine's life at its rank: a RESTARTED
        process passes a fresh incarnation BEFORE any traffic;
        broadcast seqs and round generations re-base so peers' dedup
        windows never swallow the new life's frames. incarnation > 0
        also starts the engine in joiner mode (petitioning until
        welcomed) — mirror of ProgressEngine(incarnation=...)."""
        rc = self._lib.rlo_engine_set_incarnation(self._e, incarnation)
        if rc != 0:
            raise ValueError(
                f"set_incarnation({incarnation}) failed ({rc}): the "
                f"incarnation must not go backwards, be negative, or "
                f"exceed the world-size-qualified cap (the shifted "
                f"gen base must fit int32 after * world_size)")

    def rejoin(self) -> int:
        """Explicitly petition for readmission with a fresh
        incarnation (docs/DESIGN.md §8) — mirror of
        ProgressEngine.rejoin(). Returns the new incarnation."""
        rc = self._lib.rlo_engine_rejoin(self._e)
        if rc < 0:
            raise RuntimeError(f"rejoin failed ({rc})")
        return rc

    @property
    def epoch(self) -> int:
        return self._lib.rlo_engine_epoch(self._e)

    @property
    def epoch_quarantined(self) -> int:
        return self._lib.rlo_engine_epoch_quarantined(self._e)

    @property
    def rejoins(self) -> int:
        return self._lib.rlo_engine_rejoins(self._e)

    @property
    def awaiting_welcome(self) -> bool:
        return bool(self._lib.rlo_engine_awaiting_welcome(self._e))

    def rank_failed(self, rank: int) -> bool:
        return bool(self._lib.rlo_engine_rank_failed(self._e, rank))

    @property
    def failed_count(self) -> int:
        return self._lib.rlo_engine_failed_count(self._e)

    @property
    def suspected_self(self) -> bool:
        return bool(self._lib.rlo_engine_suspected_self(self._e))

    def state_dict(self) -> dict:
        """Quiesced-engine snapshot (~checkpoint.engine_state_dict for
        the C engine); raises if the engine has in-flight, pending, or
        undelivered work."""
        st = _EngineState()
        rc = self._lib.rlo_engine_state_get(self._e, C.byref(st))
        if rc != 0:
            raise RuntimeError(
                "engine busy: drain and pick up everything before "
                "snapshotting" if rc == ERR_BUSY else f"error {rc}")
        return {f: getattr(st, f) for f, _ in _EngineState._fields_}

    def load_state_dict(self, state: dict) -> None:
        st = _EngineState(**state)
        rc = self._lib.rlo_engine_state_set(self._e, C.byref(st))
        if rc != 0:
            raise ValueError(f"snapshot rejected ({rc}): rank/world "
                             f"mismatch or bad argument")

    def idle(self) -> bool:
        return bool(self._lib.rlo_engine_idle(self._e))

    @property
    def err(self) -> int:
        return self._lib.rlo_engine_err(self._e)

    @property
    def total_pickup(self) -> int:
        return self._lib.rlo_engine_total_pickup(self._e)

    @property
    def sent_bcast_cnt(self) -> int:
        return self._lib.rlo_engine_sent_bcast(self._e)

    @property
    def recved_bcast_cnt(self) -> int:
        return self._lib.rlo_engine_recved_bcast(self._e)

    def close(self) -> None:
        if self._e:
            self._lib.rlo_engine_free(self._e)
            self._e = None
        if self in self.world.engines:
            self.world.engines.remove(self)


# -- pure-function wrappers for parity tests --------------------------------

def level(ws: int, rank: int) -> int:
    return load().rlo_level(ws, rank)


def last_wall(ws: int, rank: int) -> int:
    return load().rlo_last_wall(ws, rank)


def send_list(ws: int, rank: int):
    out = (C.c_int * 64)()
    chan = C.c_int()
    n = load().rlo_send_list(ws, rank, out, 64, C.byref(chan))
    assert n >= 0
    return tuple(out[:n]), chan.value


def check_passed_origin(ws: int, my_rank: int, origin: int,
                        to_rank: int) -> bool:
    return bool(load().rlo_check_passed_origin(ws, my_rank, origin,
                                               to_rank))


def fwd_targets(ws: int, rank: int, origin: int, from_rank: int):
    out = (C.c_int * 64)()
    n = load().rlo_fwd_targets(ws, rank, origin, from_rank, out, 64)
    assert n >= 0
    return tuple(out[:n])


def fwd_send_cnt(ws: int, rank: int, origin: int, from_rank: int) -> int:
    return load().rlo_fwd_send_cnt(ws, rank, origin, from_rank)


def initiator_targets(ws: int, rank: int):
    out = (C.c_int * 64)()
    n = load().rlo_initiator_targets(ws, rank, out, 64)
    assert n >= 0
    return tuple(out[:n])


def frame_roundtrip(origin: int, pid: int, vote: int, payload: bytes,
                    seq: int = -1):
    """Encode then decode one frame through the C wire format."""
    from rlo_tpu_torch.wire import HEADER_SIZE
    lib = load()
    cap = HEADER_SIZE + len(payload)
    raw = (C.c_uint8 * cap)()
    n = lib.rlo_frame_encode(raw, cap, origin, pid, vote, seq,
                             _buf(payload), len(payload))
    assert n == cap, n
    o = C.c_int32()
    p = C.c_int32()
    v = C.c_int32()
    s = C.c_int32()
    pp = C.POINTER(C.c_uint8)()
    m = lib.rlo_frame_decode(raw, n, C.byref(o), C.byref(p), C.byref(v),
                             C.byref(s), C.byref(pp))
    assert m >= 0, m
    data = bytes(C.cast(pp, C.POINTER(C.c_uint8 * m)).contents) if m else b""
    return o.value, p.value, v.value, data, bytes(raw), s.value


def frame_epoch(raw: bytes) -> int:
    """Read the link-epoch field of an encoded frame (C accessor —
    the parity twin of wire.Frame.decode(raw).epoch)."""
    from rlo_tpu_torch.wire import HEADER_SIZE
    if len(raw) < HEADER_SIZE:
        raise ValueError(f"frame too short: {len(raw)} < {HEADER_SIZE}")
    return load().rlo_frame_epoch(_buf(raw))


def frame_set_epoch(raw: bytes, epoch: int) -> bytes:
    """Return ``raw`` with its link-epoch field restamped through the C
    send-gate accessor (parity twin of wire.restamp_epoch)."""
    from rlo_tpu_torch.wire import HEADER_SIZE
    if len(raw) < HEADER_SIZE:
        raise ValueError(f"frame too short: {len(raw)} < {HEADER_SIZE}")
    buf = _buf(raw)
    load().rlo_frame_set_epoch(buf, epoch)
    return bytes(buf)


def telem_encode(rank: int, epoch: int, seq: int, values,
                 prev=None, full: bool = False) -> bytes:
    """Encode one telemetry digest through the C codec — the byte-
    parity twin of wire.encode_telem (docs/DESIGN.md §17). ``values``
    (and optional ``prev``) are sequences in wire.TELEM_KEYS order."""
    from rlo_tpu_torch.wire import TELEM_HEADER_SIZE, TELEM_KEYS
    if len(values) != len(TELEM_KEYS):
        raise ValueError(f"need {len(TELEM_KEYS)} values, got "
                         f"{len(values)}")
    lib = load()
    cap = TELEM_HEADER_SIZE + 10 * len(TELEM_KEYS)
    buf = (C.c_uint8 * cap)()
    vals = (C.c_int64 * len(TELEM_KEYS))(*[int(v) for v in values])
    pv = None
    if prev is not None and not full:
        pv = (C.c_int64 * len(TELEM_KEYS))(*[int(v) for v in prev])
    n = lib.rlo_telem_encode(buf, cap, rank, epoch, seq,
                             1 if (full or prev is None) else 0,
                             vals, pv)
    if n < 0:
        raise ValueError(f"rlo_telem_encode failed ({n})")
    return bytes(buf[:n])


def telem_decode(raw: bytes):
    """Decode one digest through the C codec: ``(rank, epoch, seq,
    full, {key: delta})`` — the parity twin of wire.decode_telem."""
    from rlo_tpu_torch.wire import TELEM_KEYS
    lib = load()
    rank = C.c_int32()
    epoch = C.c_int32()
    seq = C.c_uint32()
    full = C.c_int()
    deltas = (C.c_int64 * len(TELEM_KEYS))()
    mask = C.c_uint64()
    n = lib.rlo_telem_decode(_buf(raw), len(raw), C.byref(rank),
                             C.byref(epoch), C.byref(seq),
                             C.byref(full), deltas, C.byref(mask))
    if n < 0:
        raise ValueError(f"rlo_telem_decode failed ({n})")
    out = {k: deltas[i] for i, k in enumerate(TELEM_KEYS)
           if mask.value & (1 << i)}
    return rank.value, epoch.value, seq.value, bool(full.value), out


def telem_key_names():
    """The C codec's schema key table (rlo_wire.c k_telem_keys) — the
    runtime face of the rlo-lint R2 TELEM pin."""
    from rlo_tpu_torch.wire import TELEM_KEYS
    lib = load()
    return tuple(lib.rlo_telem_key_name(i).decode()
                 for i in range(len(TELEM_KEYS)))


def span_encode(gateway: int, seq: int, stage: int, t_usec: int,
                flags: int = 1) -> bytes:
    """Encode one span-context trailer through the C codec — the
    byte-parity twin of wire.encode_span_ctx (docs/DESIGN.md §19)."""
    from rlo_tpu_torch.wire import SPAN_CTX_SIZE
    lib = load()
    buf = (C.c_uint8 * SPAN_CTX_SIZE)()
    n = lib.rlo_span_encode(buf, SPAN_CTX_SIZE, gateway, seq, stage,
                            flags, t_usec)
    if n < 0:
        raise ValueError(f"rlo_span_encode failed ({n})")
    return bytes(buf[:n])


def span_decode(raw: bytes):
    """Decode a span context through the C codec: ``(flags, stage,
    gateway, seq, t_usec)`` or None when ``raw`` does not start with
    one — the parity twin of wire.decode_span_ctx."""
    lib = load()
    gateway = C.c_int32()
    seq = C.c_int32()
    stage = C.c_int()
    flags = C.c_int()
    t_usec = C.c_uint64()
    n = lib.rlo_span_decode(_buf(raw), len(raw), C.byref(gateway),
                            C.byref(seq), C.byref(stage),
                            C.byref(flags), C.byref(t_usec))
    if n < 0:
        return None
    return (flags.value, stage.value, gateway.value, seq.value,
            t_usec.value)


def run_judged_proposal(world_size: int, payload: bytes, proposer: int,
                        judge_for=None, action_cb=None, pid: int = None
                        ) -> int:
    """One complete IAR consensus round on a fresh in-process C world:
    rank `proposer` submits `payload`, every rank judges it with
    ``judge_for(rank)`` (None = approve), approving ranks fire
    ``action_cb(rank, payload)``; returns the decision (0/1).

    The shared plumbing behind NativeBackend.consensus and the hybrid
    bridge's propose_collective (~RLO_submit_proposal + callbacks,
    reference rootless_ops.c:876, :698, :842)."""
    if not 0 <= proposer < world_size:
        raise ValueError(f"proposer {proposer} out of range "
                         f"[0, {world_size})")
    world = NativeWorld(world_size)
    try:
        engines = [NativeEngine(
            world, r,
            judge_cb=(judge_for(r) if judge_for is not None else None),
            action_cb=(None if action_cb is None else
                       (lambda p, ctx, r=r: action_cb(r, p))))
            for r in range(world_size)]
        rc = engines[proposer].submit_proposal(
            payload, pid=proposer if pid is None else pid)
        if rc == -1:
            world.drain()
            rc = engines[proposer].vote_my_proposal()
        if rc not in (0, 1):
            raise RuntimeError(f"consensus incomplete ({rc})")
        world.drain()
        return int(rc)
    finally:
        world.close()


def bench_allreduce(world_size: int, count: int, reps: int = 5) -> float:
    """Median usec per wholly-native bcast-gather fp32 allreduce of
    `count` floats per rank (no Python in the measured loop); raises on
    native failure."""
    rc = load().rlo_bench_allreduce(world_size, count, reps)
    if rc < 0:
        raise RuntimeError(f"native bench failed ({int(rc)})")
    return float(rc)


def bench_allreduce_ring(world_size: int, count: int,
                         reps: int = 5) -> float:
    """Median usec per wholly-native RING fp32 allreduce (rlo_coll.c
    state machines round-robined in C) — the bandwidth-optimal
    comparison line against bench_allreduce's bcast-gather."""
    rc = load().rlo_bench_allreduce_ring(world_size, count, reps)
    if rc < 0:
        raise RuntimeError(f"native ring bench failed ({int(rc)})")
    return float(rc)


def bench_bcast_usec(world_size: int, nbytes: int, reps: int = 5) -> float:
    """Median usec per wholly-native rootless broadcast of `nbytes`
    (initiation to full delivery; rlo_demo's nbcast floor line)."""
    rc = load().rlo_bench_bcast_usec(world_size, nbytes, reps)
    if rc < 0:
        raise RuntimeError(f"native bcast bench failed ({int(rc)})")
    return float(rc)


def now_usec() -> int:
    return load().rlo_now_usec()


# -- native tracing (twin of rlo_tpu_torch.utils.tracing) -------------------

def trace_set(enabled: bool) -> None:
    load().rlo_trace_set(1 if enabled else 0)


def trace_clear() -> None:
    load().rlo_trace_clear()


def trace_dropped() -> int:
    return load().rlo_trace_dropped()


def trace_capacity() -> int:
    return load().rlo_trace_capacity()


def trace_emit(rank: int, kind: int, a: int = 0, b: int = 0,
               c: int = 0, d: int = 0) -> None:
    """Emit one event into the native ring (test support — the C
    engine emits its own protocol events)."""
    load().rlo_trace_emit(rank, int(kind), a, b, c, d)


def trace_drain(max_events: int = 65536):
    """Drain native trace events as dicts matching Event.to_dict() —
    the per-rank dump schema rlo_tpu_torch/utils/timeline.py merges."""
    from rlo_tpu_torch.utils.tracing import Ev
    buf = (_TraceEvent * max_events)()
    n = load().rlo_trace_drain(buf, max_events)
    return [{"ts_usec": buf[i].ts_usec, "rank": buf[i].rank,
             "kind": Ev(buf[i].kind).name, "a": buf[i].a, "b": buf[i].b,
             "c": buf[i].c, "d": buf[i].d}
            for i in range(n)]
