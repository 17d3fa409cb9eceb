"""Progress engine: cooperative-polling state machine driving all ops.

The port's own copy of ``rlo_tpu/engine.py``, line for line: only the
imports and the logger name differ, so both packages' engines send the
same frames, emit the same trace events and keep the same metrics for
the same scenario (``tests/test_torch_engine.py`` holds them equal).

Reference parity: `struct progress_engine` + `make_progress_gen`
(rootless_ops.c:202-253, 551-658), the EngineManager global
registry (:33-47, 407-466), pickup/recycle delivery (:938-992), the rootless
broadcast initiation/forwarding (:1581-1604, 1104-1225) and the IAR
leaderless-consensus handlers (:668-932). Same control-flow inversion as the
reference: **no background thread** — every public call turns the gears via
``progress_all()``, which steps every live engine so engines co-progress each
other (multi-engine multiplexing, testcases.c:110-241).

Deliberate departures from the reference (SURVEY.md §7 "quirks not to
replicate"):
  - votes are sent nonblocking (the reference uses blocking MPI_Send at
    rootless_ops.c:735 — a latent deadlock at scale);
  - frames are variable-size (reference always ships 32 KB, :1588);
  - explicit state enums instead of flag soup (the abandoned
    progress_engine.h design the reference never landed);
  - messages are plain GC'd objects — pickup/recycle keeps the reference's
    delivery *semantics* (a message can be picked up while still
    forwarding) without manual buffer ownership;
  - reliable delivery and bounded ops (net-new; the reference has no
    timeouts, retries, or loss recovery — SURVEY.md §5): opt-in ARQ
    (``arq_rto``) retransmits unacked frames with per-link sequence
    numbers and receive-side dedup, and op deadlines (``op_deadline`` /
    per-call ``deadline=``) make every bcast/proposal complete or FAIL
    deterministically, with a rootless ABORT unparking relays
    (docs/DESIGN.md §6).
"""

from __future__ import annotations

import enum
import heapq
import itertools
import logging
import struct
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Set

from rlo_tpu_torch import topology
from rlo_tpu_torch.transport.base import SendHandle, Transport
from rlo_tpu_torch.utils.metrics import (ENGINE_COUNTER_KEYS, ENGINE_PHASE_KEYS,
                                   Histogram, LinkStats)
from rlo_tpu_torch.utils.tracing import TRACER, Ev
from rlo_tpu_torch.wire import (ARQ_EXEMPT_TAGS, BCAST_TAGS, EPOCH_EXEMPT_TAGS,
                          Frame, MSG_SIZE_MAX, SPAN_CTX_SIZE, Tag,
                          decode_span_ctx, restamp_epoch, restamp_link)

logger = logging.getLogger("rlo_tpu_torch.engine")

#: phase name -> trace index (Ev.PHASE's a field) — fixed by the
#: ENGINE_PHASE_KEYS snapshot order the C core shares
_PHASE_IDX = {k: i for i, k in enumerate(ENGINE_PHASE_KEYS)}

#: Prefix marking an IAR proposal payload as an internal membership
#: admission round (docs/DESIGN.md §8): the engine judges and executes
#: these itself (the rootless consensus op voting on its own
#: membership) instead of handing them to the application callbacks.
#: Admission rounds use pids in the reserved NEGATIVE pid namespace.
#: Version 2 (docs/DESIGN.md §18) is a BATCHED record — one round
#: admits every queued petition at once:
#:   MAGIC + <ii>(new_epoch, k) + k x <ii>(joiner, incarnation)
MEMBER_MAGIC = b"RLOJ\x02"

#: Tag.MSYNC payload kind bytes (docs/DESIGN.md §18): the view-state
#: sync channel multiplexes a catch-up request/response pair and the
#: digest-scoped re-flood advert/want pair over one epoch- and
#: ARQ-exempt tag.
#:   REQ  = <B> + <ii>(requester epoch, requester incarnation)
#:   RSP  = <B> + <ii>(epoch, n) + n x <iii>(member, reset_epoch,
#:          admitted_inc) + the responder's recent-log advert tail
#:          (<i>count + count x <iii> entry identities)
#:   AD   = <B> + <i>count + count x <iii>(tag, a, b) identities:
#:          BCAST -> (origin, seq); DECISION/ABORT -> (pid, gen);
#:          FAILURE -> (failed rank, declarer epoch)
#:   WANT = <B> + <i>count + count x <iii> — the advert entries the
#:          receiver provably misses, echoed back verbatim
MSYNC_REQ = 0
MSYNC_RSP = 1
MSYNC_AD = 2
MSYNC_WANT = 3

#: Membership admission rounds live in the reserved pid namespace
#: pid <= MEMBER_PID_BASE; app pids are >= -1 (-1 is the unset
#: sentinel). pid = MEMBER_PID_BASE - (joiner * world_size + proposer)
#: keeps CONCURRENT admissions of one joiner by different proposers on
#: distinct pids (IAR forbids concurrent same-pid proposals); the
#: second decision's admission is an idempotent no-op.
MEMBER_PID_BASE = -2

#: Tags a user may hand to ``send_direct``: delivered via the
#: ``_on_other`` pickup route at the destination, never interpreted by
#: the engine (Tag.SERVE is the serving fabric's load-report channel,
#: docs/DESIGN.md §11; Tag.TELEM carries the telemetry plane's
#: delta-encoded digests, docs/DESIGN.md §17).
DIRECT_TAGS = frozenset({Tag.SERVE, Tag.P2P, Tag.DATA, Tag.SYS,
                         Tag.TELEM})

#: Incarnation-partitioned sequence spaces: a restarted rank's fresh
#: broadcast seqs and round generations start at ``incarnation << 20``,
#: above anything its previous life can have used, so peers' per-origin
#: dedup windows never swallow post-restart traffic and stale
#: old-incarnation frames always fall below the watermark. Bounds each
#: incarnation to ~1M broadcasts/rounds (documented in DESIGN.md §8).
INCARNATION_SHIFT = 20
def _incarnation_cap(world_size: int) -> int:
    """Largest incarnation whose shifted seq/gen base still fits the
    int32 wire fields AFTER the rank-qualification multiply (gen =
    counter * world_size + rank, see submit_proposal) — enforced at
    construction and in rejoin(), mirrored by
    rlo_engine_set_incarnation."""
    return ((2**31 - 1) // max(world_size, 1)) >> INCARNATION_SHIFT


def _trace_ident(tag: int, frame: Frame) -> int:
    """Correlation identity a trace event carries in its c field: the
    per-origin exactly-once seq for Tag.BCAST (it travels in the vote
    field), the pid for everything else (proposals/decisions/aborts
    carry the round pid there; FAILURE notices the failed rank)."""
    return frame.vote if tag == Tag.BCAST else frame.pid


class ReqState(enum.IntEnum):
    """Reference RLO_Req_stat (rootless_ops.h:63-68)."""
    COMPLETED = 0
    IN_PROGRESS = 1
    FAILED = 2
    INVALID = 3


# judge/action callbacks: (payload: bytes, app_ctx) -> int / None
# (reference iar_cb_func_t, rootless_ops.h:77)
JudgeCb = Callable[[bytes, object], int]
ActionCb = Callable[[bytes, object], object]


@dataclass
class UserMsg:
    """What pickup_next hands the application (~RLO_user_msg,
    rootless_ops.h:84-91, decoded as in _user_msg_mock :920-932)."""
    type: int          # Tag value
    origin: int        # broadcast initiator rank
    pid: int = -1
    vote: int = -1
    data: bytes = b""


@dataclass
class ProposalState:
    """Per-proposal consensus bookkeeping (~Proposal_state,
    rootless_ops.c:184-194)."""
    pid: int = -1
    gen: int = -1                # round generation (disambiguates pid reuse)
    recv_from: int = -1          # parent in the vote tree
    vote: int = 1
    votes_needed: int = 0
    votes_recved: int = 0
    state: ReqState = ReqState.INVALID
    proposal_payload: bytes = b""
    decision_handles: List[SendHandle] = field(default_factory=list)
    decision_pending: bool = False
    # direct children whose (subtree-merged) votes are still outstanding;
    # lets the failure detector discount a dead child so consensus
    # completes instead of waiting forever (net-new vs the reference)
    await_from: List[int] = field(default_factory=list)
    # additional vote-tree parents acquired from duplicate proposals
    # (re-formed overlay trees during view changes); they receive the
    # SAME merged vote as recv_from when the round resolves — voting an
    # interim verdict to them could lose a subtree veto still in flight
    # (found in review)
    dup_parents: List[int] = field(default_factory=list)
    # the merged vote has been determined and sent up — a later
    # duplicate's parent can safely receive it immediately
    resolved: bool = False
    # absolute clock time by which the round must resolve, else the
    # proposer transitions to FAILED and broadcasts a rootless ABORT
    # (op-deadline machinery; None = no deadline)
    deadline: Optional[float] = None


@dataclass
class _Msg:
    """Internal in-flight message (~RLO_msg_t, rootless_ops.h:93-146)."""
    frame: Frame
    tag: int
    src: int = -1                       # immediate sender (~MPI_SOURCE)
    send_handles: List[SendHandle] = field(default_factory=list)
    pickup_done: bool = False
    fwd_done: bool = False
    prop_state: Optional[ProposalState] = None
    # op-deadline bookkeeping (net-new): absolute clock time by which
    # this op's outbound work must complete, else it transitions to
    # FAILED and is abandoned instead of tracked forever
    deadline: Optional[float] = None
    state: ReqState = ReqState.IN_PROGRESS
    # metrics stamps (None = metrics were off at the event — a None
    # sentinel, not 0.0, so an injectable simulated clock starting at
    # t=0 still records): initiation time of a locally-initiated bcast
    # (op-latency histogram) and receipt time of a deliverable message
    # (pickup-wait histogram)
    born: Optional[float] = None
    arrived: Optional[float] = None
    # profiler stamps (None = profiler off at init, docs/DESIGN.md §10):
    # bcast init time for the first-forward/all-delivered phase timers,
    # and whether the first fan-out completion was already observed
    p_born: Optional[float] = None
    first_fwd: bool = False

    def sends_done(self) -> bool:
        return all(h.done() for h in self.send_handles)


@dataclass
class _ArqEntry:
    """One unacknowledged reliable frame awaiting its cumulative ACK
    (the sender half of the ARQ state machine)."""
    tag: int
    raw: bytes            # encoded frame, seq already stamped
    due: float            # next retransmit time
    retries: int = 0
    sent: float = 0.0     # first-transmission time (RTT sampling)


class EngineManager:
    """Global registry of live engines (~EngineManager/Active_Engines,
    rootless_ops.c:33-47). progress_all steps every engine one turn."""

    def __init__(self):
        self.engines: List["ProgressEngine"] = []
        self._ids = itertools.count()
        self._stepping = False

    def append(self, eng: "ProgressEngine") -> int:
        self.engines.append(eng)
        return next(self._ids)

    def remove(self, eng: "ProgressEngine") -> None:
        if eng in self.engines:
            self.engines.remove(eng)

    def progress_all(self) -> None:
        # handlers may initiate broadcasts (e.g. the decision bcast inside
        # the vote handler), which call back into progress_all — make
        # re-entrant turns no-ops instead of recursing
        if self._stepping:
            return
        self._stepping = True
        try:
            for eng in list(self.engines):
                eng._progress_once()
        finally:
            self._stepping = False


MANAGER = EngineManager()


def progress_all() -> None:
    """Turn every live engine's gears one step (~RLO_make_progress_all,
    rootless_ops.c:538-549)."""
    MANAGER.progress_all()


class ProgressEngine:
    """One rank's engine instance over a transport endpoint.

    ~RLO_progress_engine_new (rootless_ops.c:467-522). Multiple engines may
    coexist (each over its own transport, the analogue of the reference's
    dup'ed communicator per engine).
    """

    def __init__(self, transport: Transport,
                 judge_cb: Optional[JudgeCb] = None,
                 app_ctx: object = None,
                 action_cb: Optional[ActionCb] = None,
                 msg_size_max: int = MSG_SIZE_MAX,
                 manager: EngineManager = MANAGER,
                 failure_timeout: Optional[float] = None,
                 heartbeat_interval: Optional[float] = None,
                 failure_cb: Optional[Callable[[int, bool], None]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 members: Optional[Sequence[int]] = None,
                 fanout: Optional[str] = None,
                 arq_rto: Optional[float] = None,
                 arq_max_retries: int = 8,
                 op_deadline: Optional[float] = None,
                 incarnation: int = 0):
        """``failure_timeout`` (seconds) enables the net-new failure
        detector (the reference defines RLO_FAILED but never assigns it,
        SURVEY.md §5): ranks heartbeat their ring successor every
        ``heartbeat_interval`` (default timeout/4) and declare their
        predecessor failed after ``failure_timeout`` of silence, then
        notify the world with a rootless FAILURE broadcast. Survivors
        elastically re-form the overlay (topology recomputed over the
        alive set) so broadcasts and consensus keep working.
        ``failure_cb(rank, detected_locally)`` fires once per learned
        failure. ``clock`` is injectable for deterministic tests.

        ``members`` restricts the engine to a RANK SUBSET — the
        reference's engines-over-sub-communicators capability
        (RLO_progress_engine_new on any MPI_Comm,
        rootless_ops.c:467, 1461). The overlay topology is computed
        over virtual ranks 0..len(members)-1 (the same translation the
        elastic re-forming uses), so bcast/IAR span exactly the member
        set; non-members never see this engine's traffic. This rank
        must be a member; create the subset engine only on member
        ranks.

        ``fanout`` selects the spanning-tree shape (mirror of the C
        engine's rlo_engine_set_fanout / RLO_FANOUT): 'skip_ring'
        (default — the reference overlay) or 'flat' (depth-1: the
        origin sends to every live member, receivers are leaves — the
        right shape when scheduling latency dominates). Rootlessness,
        dedup, and IAR vote accounting are schedule-independent.
        Default from $RLO_FANOUT, else 'skip_ring'.

        ``arq_rto`` (seconds) enables the reliable-delivery layer (the
        reference is fire-and-forget: no timeouts, retries, or loss
        recovery, SURVEY.md §5): every engine frame except heartbeats
        and ACKs is stamped with a per-(src, dst) link sequence number
        and kept in a retransmit queue until the destination's
        cumulative ACK covers it; unacked frames retransmit after
        ``arq_rto`` with exponential backoff, giving up after
        ``arq_max_retries`` (liveness of a persistently silent peer is
        the failure detector's job, not ARQ's). Receivers dedup on
        (sender, seq) BEFORE tag dispatch, so retransmits are
        idempotent through the store-and-forward broadcast path.

        ``incarnation`` identifies this engine's life at its rank
        (docs/DESIGN.md §8): a restarted process passes a HIGHER
        incarnation than its previous life (or calls ``rejoin()``,
        which bumps it) so survivors can tell its fresh traffic from
        the dead incarnation's. Broadcast sequence numbers and round
        generations are partitioned by incarnation (each life starts
        its counters at ``incarnation << 20``), keeping the
        exactly-once dedup windows correct across restarts without any
        persisted state. An engine constructed with ``incarnation > 0``
        starts in JOINER mode: it quarantines everything and petitions
        with Tag.JOIN probes until a surviving member admits it
        (docs/DESIGN.md §8).

        ``op_deadline`` (seconds, relative) is the default deadline for
        bcast/submit_proposal ops; per-call ``deadline=`` overrides. A
        proposal that has not resolved by its deadline transitions to
        ReqState.FAILED (finally assigning the reference's dead enum
        value) and the proposer broadcasts a rootless Tag.ABORT so
        relays unpark the round and deliver the failure to the app via
        pickup instead of waiting forever; the pid is then free to
        resubmit on the (possibly re-formed) survivor topology."""
        ws = transport.world_size
        if ws < 2:  # bcomm_init rejects this (rootless_ops.c:1464)
            raise ValueError(f"world_size must be >= 2, got {ws}")
        if fanout is None:
            import os
            fanout = ("flat" if os.environ.get("RLO_FANOUT") == "flat"
                      else "skip_ring")
        if fanout not in ("skip_ring", "flat"):
            raise ValueError(
                f"unknown fanout {fanout!r}; known: 'skip_ring', 'flat'")
        self.fanout = fanout
        self.transport = transport
        self.rank = transport.rank
        self.world_size = ws
        self.msg_size_max = msg_size_max
        self.judge_cb = judge_cb
        self.app_ctx = app_ctx
        self.action_cb = action_cb

        # topology snapshot (~bcomm fields)
        self.my_level = topology.level(ws, self.rank)
        self.initiator_targets = topology.initiator_targets(ws, self.rank)

        # queues (~rootless_ops.c:206-211); recv queue is implicit in
        # transport.poll()
        self.queue_wait: List[_Msg] = []
        self.queue_pickup: deque = deque()
        self.queue_wait_and_pickup: List[_Msg] = []
        self.queue_iar_pending: List[_Msg] = []

        # counters (~rootless_ops.c:217-219 and header total_pickup)
        self.sent_bcast_cnt = 0
        self.recved_bcast_cnt = 0
        self.total_pickup = 0

        self.my_own_proposal = ProposalState()
        self.my_proposal_payload: bytes = b""
        # per-engine round counter: a proposer may reuse a pid across
        # sequential rounds; the generation travels in the proposal
        # frame's vote field and is echoed by every vote and decision,
        # so a stale message from an earlier same-pid round can never
        # be merged into a later one. Persisted by engine snapshots so
        # a restored engine never reissues a pre-snapshot generation;
        # incarnation-partitioned so an unsnapshotted restart never
        # reissues one either.
        self._gen_next = (incarnation << INCARNATION_SHIFT) + 1

        # exactly-once broadcast bookkeeping: every Tag.BCAST frame this
        # rank initiates is stamped with a monotone sequence number (in
        # the frame's otherwise-unused vote field); receivers dedup on
        # (origin, seq) so a broadcast whose forwarding crosses a
        # membership change can never deliver twice, and survivors
        # re-flood their recent-broadcast log on every view change so it
        # cannot be lost either (see _mark_failed). Incarnation-
        # partitioned: a restarted rank's fresh seqs start above its
        # previous life's, so peers' dedup windows stay correct.
        self._bcast_seq = incarnation << INCARNATION_SHIFT
        # origin -> [contig, set(seqs > contig)]: all seqs <= contig seen
        self._seen_bcast: dict = {}
        # ring log of recently initiated/forwarded BCAST frames (raw
        # bytes), flooded point-to-point on view changes
        self._recent_bcasts: deque = deque(maxlen=64)
        # settled consensus rounds: decisions forwarded by a mix of
        # old- and new-topology trees during a view change can reach a
        # rank twice; a settled (pid, gen) is delivered exactly once
        # (the IAR analogue of the (origin, seq) broadcast dedup)
        self._settled_rounds: deque = deque(maxlen=256)
        self._settled_set: Set = set()

        # failure detection (net-new; SURVEY.md §5 "failure detection:
        # none" in the reference)
        self.failure_timeout = failure_timeout
        self.heartbeat_interval = heartbeat_interval or (
            failure_timeout / 4 if failure_timeout else None)
        self.failure_cb = failure_cb
        self.clock = clock
        self.failed: Set[int] = set()
        self.suspected_self = False
        # shared identity view (big-world construction path): the
        # pre-failure alive list and rank->virtual map are identical
        # for every engine of a world, so they are shared, not copied
        # — 10k-rank protocol-only sims would otherwise spend gigabytes
        # and a minute of wall time on per-engine identity dicts. Both
        # are rebound (never mutated in place) on every view change.
        self._alive: List[int] = topology.identity_members(ws)
        self._v = topology.IDENTITY_VMAP  # real rank -> virtual rank
        # ring-neighbor cache keyed by _alive object identity (see
        # _ring_neighbors)
        self._ring_view: Optional[List[int]] = None
        self._ring_nbrs = (0, 0)
        self._hb_last_sent = float("-inf")
        self._hb_seen: dict = {}  # sender rank -> last heartbeat clock

        # reliable delivery (ARQ; net-new — SURVEY.md §5 "no timeouts,
        # retries, or loss recovery" in the reference)
        if arq_rto is not None and arq_rto <= 0:
            raise ValueError(f"arq_rto must be positive, got {arq_rto}")
        self.arq_rto = arq_rto
        self.arq_max_retries = arq_max_retries
        self._tx_seq: dict = {}       # dst -> next link seq
        self._tx_unacked: dict = {}   # dst -> {seq: _ArqEntry}
        self._tx_skip: dict = {}      # dst -> [given-up seq, next send]
        self._rx_seen: dict = {}      # src -> [contig, set(seqs > contig)]
        self._ack_due: Set[int] = set()  # srcs owed a cumulative ACK
        # batched due-list keyed by deadline (ROADMAP item 2): a lazy
        # min-heap of (due, dst, seq) wake-ups — seq -1 marks a skip-
        # notice deadline — so the per-tick retransmit scan is O(1)
        # peek-and-return until something is actually due, instead of
        # a per-frame walk of every unacked queue on every progress
        # turn. Entries are never removed eagerly: an entry whose
        # (dst, seq) no longer matches the live due (acked, resent
        # with backoff, failed peer) is stale and popped on sight.
        # The heap only GATES the sweep — the sweep itself still walks
        # in the original (dst insertion, seq) order, so retransmit
        # ordering (and with it every seed-exact simulator schedule)
        # is byte-identical to the un-gated scan.
        self._arq_due: List[tuple] = []
        # ARQ counters — part of the metrics registry snapshot
        # (metrics()["counters"]); the attributes are the canonical
        # storage and remain the public aliases older tests read
        self.arq_retransmits = 0
        self.arq_dup_drops = 0
        self.arq_gave_up = 0

        # op deadlines (net-new): ops complete or FAIL deterministically
        self.op_deadline = op_deadline
        self.ops_failed = 0

        # membership epochs + elastic rejoin (docs/DESIGN.md §8).
        # ``epoch`` is this rank's monotone view counter: every failure
        # declaration/adoption and every admission bumps it, and the
        # send gate stamps it into every outgoing frame (retransmits
        # and re-floods are restamped with the CURRENT epoch).
        # ``_epoch_floor[sender]`` is the minimum frame epoch accepted
        # from a readmitted sender — everything below it is the dead
        # incarnation's stale traffic and is quarantined, not
        # dispatched. ``_awaiting_welcome`` is the joiner-side gate: a
        # rank that has learned it must rejoin quarantines EVERYTHING
        # except membership frames until the admitting proposer's
        # JOIN_WELCOME arrives (this is what closes the stale-ACK race
        # on link-sequence resets — see _execute_admission).
        inc_cap = _incarnation_cap(self.world_size)
        if not 0 <= incarnation <= inc_cap:
            raise ValueError(
                f"incarnation must be in [0, {inc_cap}] for "
                f"world_size {self.world_size} (the shifted, "
                f"rank-qualified gen base must fit int32 wire "
                f"fields), got {incarnation}")
        self.incarnation = incarnation
        self.epoch = 0
        self.epoch_quarantined = 0
        self.rejoins = 0
        # heal-cost counters (docs/DESIGN.md §17): always-live plain
        # ints like every other counter — the telemetry plane and the
        # churn benches read them through metrics(); rlo-lint R2 pins
        # the schema against the C engine's rlo_stats
        self.view_changes = 0
        self.reflood_frames = 0
        self.epoch_lag_max = 0
        self.quar_mid_rejoin = 0
        self.quar_failed_sender = 0
        self.quar_below_floor = 0
        self.admission_rounds = 0
        self.epoch_syncs = 0
        self.reflood_skipped = 0
        self.batched_admits = 0
        self._epoch_floor: dict = {}    # sender -> min accepted epoch
        # rlo-model: edge restart->joiner
        self._awaiting_welcome = incarnation > 0
        self._join_last_probe = float("-inf")
        self._admitted: dict = {}       # joiner -> admitted incarnation
        self._admitting: Set[int] = set()  # joiners with a round in flight
        # joiner -> (incarnation, joiner epoch): petitions waiting for
        # the (single) own-proposal slot to free up
        self._pending_joins: dict = {}
        # joiner -> highest admission epoch EXECUTED here: admissions
        # are idempotent per (joiner, epoch), so a stale or duplicate
        # decision re-flooded out of an older view can never re-run
        # the link-state reset (a one-sided reset permanently desyncs
        # the ARQ windows) or resurrect a replaced membership view
        self._admit_epoch: dict = {}
        # dst -> LINK epoch: the admission epoch of the last link-state
        # reset on that edge (0 = the original link). This — not the
        # current view epoch — is what the send gate stamps into the
        # frame header: the receiver's floor is the epoch of ITS last
        # reset of the edge, so the stamp identifies which life of the
        # link a frame belongs to, and a stale life's frames (or
        # retransmits) can never pollute a freshly reset dedup window
        self._link_epoch: dict = {}
        # epoch of the last JOIN_WELCOME this rank adopted — FAILURE
        # notices about me declared below it are pre-rejoin leftovers
        self._welcome_epoch = 0
        # ranks excluded at construction by a sub-communicator engine:
        # never probed, never admitted (they are not failed members,
        # they were never members at all)
        self._sub_excluded: Set[int] = set()
        # JOIN probe cadence: the failure detector's heartbeat interval
        # when it is on, else a conservative default for explicit
        # rejoin() use on detector-less engines
        self.join_interval = self.heartbeat_interval or 0.5
        # stale-sender nack stamp: a below-floor frame from a rank we
        # consider ALIVE means it missed its JOIN_WELCOME (the welcome
        # is one-shot and ARQ-exempt) — answer with a view probe so
        # the stale island re-petitions instead of being silently
        # quarantined forever (rate-limited per sender)
        self._stale_probe_last: dict = {}
        # Tag.MSYNC view-state catch-up (docs/DESIGN.md §18): per-dst
        # sync-request cadence stamp (one REQ per join_interval — the
        # request repeats until the view catches up or falls back to a
        # full rejoin, so losing one costs a cadence tick, not heal)
        self._sync_req_last: dict = {}
        # member -> the admission epoch of the last admission round
        # this rank EXECUTED for it — unlike ``_admit_epoch`` (the
        # stale-notice floor, inflated wholesale by welcome/sync
        # adoption) this is only ever a CERTIFIED link-reset epoch, so
        # a sync response built from it can safely tell a laggard
        # which floor to set for that member. Cleared on our own
        # welcome/sync adoption: a rank that just adopted a foreign
        # view no longer certifies anyone else's reset history.
        self._reset_epoch: dict = {}

        # metrics registry (docs/DESIGN.md §7): per-link frame/byte/
        # retransmit/RTT accounting + op-latency histograms, snapshot
        # via metrics(). Disabled by default — the hot-path cost of
        # the disabled state is ONE branch per send/receive (the
        # overhead contract); counters above are plain ints and always
        # live. _mx_on gates everything that needs a clock read or a
        # per-link dict access.
        self._mx_on = False
        self._mx_link: dict = {}          # peer -> LinkStats
        self._h_bcast = Histogram()       # bcast init -> sends complete
        self._h_prop = Histogram()        # proposal submit -> decision
        self._h_pickup = Histogram()      # frame receipt -> pickup
        self._prop_born: Optional[float] = None

        # in-engine phase profiler (docs/DESIGN.md §10): per-stage log2
        # duration histograms over the ENGINE_PHASE_KEYS taxonomy —
        # hot-path stages (encode/decode/send/ARQ scan/dispatch/pickup)
        # and per-op protocol phases (bcast init->first-fwd->all-
        # delivered, proposal submit->votes->decision). Independent of
        # the metrics registry gate: off by default, and the disabled
        # path costs ONE predictable branch per instrumented site (the
        # §10 overhead contract — no clock read, no dict access).
        self._prof_on = False
        self._ph = {k: Histogram() for k in ENGINE_PHASE_KEYS}
        self._p_prop_born: Optional[float] = None

        if members is not None:
            group = sorted(set(int(r) for r in members))
            if len(group) < 2:
                raise ValueError(
                    f"a sub-communicator needs >= 2 members, got "
                    f"{group}")
            if any(r < 0 or r >= ws for r in group):
                raise ValueError(
                    f"members {group} out of range [0, {ws})")
            if self.rank not in group:
                raise ValueError(
                    f"rank {self.rank} is not in members {group}")
            # subset = the translated-topology machinery with the
            # non-members permanently excluded: every routed path
            # (_cur_initiator_targets, _fwd_targets, _ring_neighbors,
            # re-flood, discounting) already consults the alive view
            self.failed = set(range(ws)) - set(group)
            self._alive = group
            self._v = topology.virtual_map(group)
            self._sub_excluded = set(range(ws)) - set(group)
        # full-world engines share the cached identity list (group is
        # rebound on view changes, never mutated); sub-communicator
        # engines own their member list
        self.group = (self._alive if members is None
                      else list(self._alive))

        self.manager = manager
        self.engine_id = manager.append(self)

    # ------------------------------------------------------------------
    # Reliable delivery: ARQ send/receive (net-new — the reference has
    # no loss recovery at all, SURVEY.md §5). Sender half: every
    # non-exempt frame gets a per-(src, dst) link seq and sits in a
    # retransmit queue until the cumulative ACK covers it. Receiver
    # half: dedup on (immediate sender, seq) before tag dispatch —
    # retransmits are idempotent everywhere, including mid-forward in
    # the store-and-forward bcast path — then schedule a cumulative
    # ACK back (one per sender per progress turn, plus a piggyback on
    # every heartbeat). Exactly-once composes by layers: link-level
    # (src, seq) dedup absorbs ARQ retransmits; app-level (origin,
    # seq) / settled-(pid, gen) dedup absorbs view-change re-floods,
    # which travel with FRESH link seqs.
    # ------------------------------------------------------------------
    def _link(self, peer: int) -> LinkStats:
        ls = self._mx_link.get(peer)
        if ls is None:
            ls = self._mx_link[peer] = LinkStats()
        return ls

    def _phobs(self, key: str, t0: float) -> None:
        """Record one profiler stage sample: the duration since ``t0``
        into the phase's log2 histogram, plus an Ev.PHASE trace event
        when the tracer is live (the Chrome-timeline duration slice).
        Callers gate on ``_prof_on`` — this is never reached on the
        disabled path (the §10 one-branch overhead contract). The
        start/observe pattern is deliberately REPEATED inline at each
        send/encode site rather than factored into a delegating
        wrapper: a wrapper would put a Python call on the disabled
        hot path, which is exactly the overhead the contract rules
        out (the C side's isend_timed is a static function the
        compiler inlines; Python has no such luxury)."""
        dur = (self.clock() - t0) * 1e6
        self._ph[key].observe(dur)
        if TRACER.enabled:
            TRACER.emit(self.rank, Ev.PHASE, _PHASE_IDX[key],
                        min(int(dur), 2**31 - 1))

    def _isend_counted(self, dst: int, tag: int, raw: bytes) -> SendHandle:
        """tx-accounted isend for the out-of-band paths (heartbeats,
        ACKs, retransmits); fresh frames go through _send_raw, which
        inlines the same accounting to keep the hot path one branch."""
        if self._mx_on:
            ls = self._link(dst)
            ls.tx_frames += 1
            ls.tx_bytes += len(raw)
        if self._prof_on:
            t0 = self.clock()
            h = self.transport.isend(dst, int(tag), raw)
            self._phobs("send", t0)
            return h
        return self.transport.isend(dst, int(tag), raw)

    def _ep(self, dst: int) -> int:
        """The LINK epoch stamped into frames toward ``dst``: the
        admission epoch of the last link reset on that edge
        (docs/DESIGN.md §8). Receivers quarantine frames below their
        own floor for the edge, so a stale link-life's traffic can
        never touch the fresh dedup windows."""
        return self._link_epoch.get(dst, 0)

    def _send_raw(self, dst: int, tag: int, raw: bytes) -> SendHandle:
        """The one gate every fresh engine frame leaves through: stamps
        the link epoch (so a dead link-life's frames are mechanically
        distinguishable from post-reset traffic, docs/DESIGN.md §8)
        and the link seq, registering the retransmit entry when ARQ is
        on; per-link tx accounting when metrics are on (one branch
        when off — the §7 overhead contract)."""
        if self._mx_on:
            ls = self._link(dst)
            ls.tx_frames += 1
            ls.tx_bytes += len(raw)
        if self.arq_rto is None or tag in ARQ_EXEMPT_TAGS:
            raw = restamp_epoch(raw, self._ep(dst))
            if self._prof_on:
                t0 = self.clock()
                h = self.transport.isend(dst, int(tag), raw)
                self._phobs("send", t0)
                return h
            return self.transport.isend(dst, int(tag), raw)
        seq = self._tx_seq.get(dst, 0)
        self._tx_seq[dst] = seq + 1
        raw = restamp_link(raw, seq, self._ep(dst))
        due = self.clock() + self.arq_rto
        self._tx_unacked.setdefault(dst, {})[seq] = _ArqEntry(
            tag=int(tag), raw=raw, due=due, sent=due - self.arq_rto)
        heapq.heappush(self._arq_due, (due, dst, seq))
        if self._prof_on:
            t0 = self.clock()
            h = self.transport.isend(dst, int(tag), raw)
            self._phobs("send", t0)
            return h
        return self.transport.isend(dst, int(tag), raw)

    def _send(self, dst: int, tag: int, frame: Frame) -> SendHandle:
        return self._send_raw(dst, tag, frame.encode())

    @staticmethod
    def _window_record(ent: list, seq: int) -> bool:
        """Record ``seq`` in a [contig, set(seqs > contig)] watermark+
        window dedup entry; True when already seen. ONE implementation
        for both key spaces — the link-level (sender, seq) ARQ dedup
        and the broadcast-level (origin, seq) dedup (mirror of the C
        side's window_record). The 4096 compaction bounds out-of-order
        state by assuming the oldest half's gaps are lost, not late —
        see the at-least-once bound note in docs/DESIGN.md §6."""
        if seq <= ent[0] or seq in ent[1]:
            return True
        ent[1].add(seq)
        while ent[0] + 1 in ent[1]:
            ent[0] += 1
            ent[1].remove(ent[0])
        if len(ent[1]) > 4096:
            ent[0] = sorted(ent[1])[len(ent[1]) // 2]
            ent[1] = {s for s in ent[1] if s > ent[0]}
        return False

    def _rx_is_dup(self, src: int, seq: int) -> bool:
        """Link-level exactly-once receipt check, keyed on (immediate
        sender, seq)."""
        return self._window_record(
            self._rx_seen.setdefault(src, [-1, set()]), seq)

    def _rx_cum(self, src: int) -> int:
        return self._rx_seen.get(src, [-1, set()])[0]

    def _rx_skip(self, src: int, upto: int) -> None:
        """Sender-side skip notice: ``src`` gave up retransmitting
        everything <= ``upto``; advance the watermark so the hole can
        never block cumulative ACKs for later frames (without this,
        one given-up frame would force every subsequent frame on the
        link through the full retransmit-to-exhaustion cycle)."""
        ent = self._rx_seen.setdefault(src, [-1, set()])
        if upto > ent[0]:
            ent[0] = upto
            ent[1] = {s for s in ent[1] if s > upto}
            while ent[0] + 1 in ent[1]:  # holes below may now close
                ent[0] += 1
                ent[1].remove(ent[0])
            self._ack_due.add(src)  # tell the sender the new cum

    def _on_ack(self, src: int, cum: int) -> None:
        """Cumulative ACK from ``src``: everything <= cum is delivered;
        drop it from the retransmit queue (and retire a pending SKIP
        notice the ACK proves was absorbed)."""
        sk = self._tx_skip.get(src)
        if sk is not None and cum >= sk[0]:
            del self._tx_skip[src]
        q = self._tx_unacked.get(src)
        if not q:
            return
        now = self.clock() if self._mx_on else 0.0
        for seq in [s for s in q if s <= cum]:
            ent = q.pop(seq)
            if self._mx_on and ent.retries == 0:
                # RTT sample from ack timing — never-retransmitted
                # frames only (Karn's rule: a retransmitted frame's
                # ack is ambiguous about which copy it answers)
                self._link(src).rtt_sample((now - ent.sent) * 1e6)
        # unfillable hole: the receiver's watermark sits below seqs I
        # no longer hold (its window was reset by an admission/welcome
        # while mine carried on — tx seqs are monotone per lifetime).
        # I can never retransmit (cum, min held) — ACKs are FIFO per
        # channel, so the gap is permanent — so tell it to skip ahead
        # now instead of retransmitting the held frames to exhaustion
        # (which would end in a spurious half-dead-link FAILURE)
        if q:
            lo = min(q)
            if lo > cum + 1:
                sk = self._tx_skip.setdefault(
                    src, [-1, float("-inf")])
                if lo - 1 > sk[0]:
                    sk[0] = lo - 1
                    sk[1] = self.clock()  # send this tick
                    heapq.heappush(self._arq_due, (sk[1], src, -1))

    def _arq_wake(self, now: float) -> bool:
        """The due-list gate for the retransmit sweep: pop stale heap
        heads (acked, resent-with-backoff, failed-peer, or retired
        skip notices no longer match their recorded deadline) and
        report whether the earliest LIVE deadline has arrived. The
        heap is a min-heap on the deadline, so a not-yet-due head
        means nothing anywhere is due — the common idle tick returns
        here without touching a single unacked queue."""
        heap = self._arq_due
        while heap:
            due, dst, seq = heap[0]
            if seq >= 0:
                ent = self._tx_unacked.get(dst, {}).get(seq)
                live = ent is not None and ent.due == due
            else:
                sk = self._tx_skip.get(dst)
                live = sk is not None and sk[1] == due
            if not live:
                heapq.heappop(heap)
                continue
            return due <= now
        return False

    def _arq_tick(self) -> None:
        """Retransmit sweep: resend overdue unacked frames with
        exponential backoff; give up after arq_max_retries (a peer
        that silent is the failure detector's problem).

        Every give-up arms a SKIP notice (an ACK frame with the
        vote=-2 sentinel, pid = abandoned seq) telling the receiver to
        advance its watermark over the permanent hole — otherwise one
        given-up frame would pin the cumulative ACK below every later
        seq on the link, forcing each of them through the full
        retransmit-to-exhaustion cycle. The notice is only SENT once
        no lower seq is still being retried (the receiver's advanced
        watermark would misread those retransmits as duplicates), and
        it repeats at rto cadence until an ACK at or past the skipped
        seq proves the watermark moved.

        A give-up also escalates to the failure detector: a peer that
        swallowed max_retries retransmits is a half-dead link, and the
        membership layer treats it exactly like a silent heartbeat
        predecessor — declared FAILED, announced to the world, overlay
        re-formed (declared after the sweep: _mark_failed mutates the
        retransmit queues)."""
        now = self.clock()
        if not self._arq_wake(now):
            return  # nothing due: the heap gate keeps this tick O(1)
        gave_up_on: List[int] = []
        for dst, q in self._tx_unacked.items():
            if dst in self.failed:
                if q:
                    q.clear()
                self._tx_skip.pop(dst, None)
                continue
            for seq, ent in list(q.items()):
                if now < ent.due:
                    continue
                if ent.retries >= self.arq_max_retries:
                    del q[seq]
                    self.arq_gave_up += 1
                    TRACER.emit(self.rank, Ev.ARQ_GIVEUP, dst,
                                ent.retries)
                    if dst not in gave_up_on:
                        gave_up_on.append(dst)
                    sk = self._tx_skip.setdefault(dst, [-1, now])
                    if seq > sk[0]:
                        sk[0] = seq
                        sk[1] = now  # send immediately
                    heapq.heappush(self._arq_due, (sk[1], dst, -1))
                    continue
                ent.retries += 1
                ent.due = now + self.arq_rto * (2 ** ent.retries)
                heapq.heappush(self._arq_due, (ent.due, dst, seq))
                self.arq_retransmits += 1
                if self._mx_on:
                    self._link(dst).retransmits += 1
                # same seq (the receiver dedups), same link epoch (the
                # retransmit belongs to the same life of the link)
                self._isend_counted(dst, ent.tag,
                                    restamp_epoch(ent.raw,
                                                  self._ep(dst)))
            sk = self._tx_skip.get(dst)
            if sk is not None and now >= sk[1] and \
                    all(s > sk[0] for s in q):
                self._isend_counted(
                    dst, int(Tag.ACK),
                    Frame(origin=self.rank, pid=sk[0], vote=-2,
                          epoch=self._ep(dst)).encode())
                sk[1] = now + self.arq_rto
                heapq.heappush(self._arq_due, (sk[1], dst, -1))
        for dst in gave_up_on:
            if dst not in self.failed and not self._awaiting_welcome:
                logger.warning(
                    "rank %d declaring rank %d FAILED: ARQ gave up "
                    "after %d retries (half-dead link)", self.rank,
                    dst, self.arq_max_retries)
                TRACER.emit(self.rank, Ev.FAILURE, dst, 1)
                self._announce_failed(dst)

    def _flush_acks(self) -> None:
        """Send the owed cumulative ACKs (at most one per sender per
        progress turn; ACKs are themselves unreliable — a lost one
        just costs one more retransmit+dedup round trip)."""
        for src in self._ack_due:
            if src in self.failed or src == self.rank:
                continue
            self._isend_counted(
                src, int(Tag.ACK),
                Frame(origin=self.rank, vote=self._rx_cum(src),
                      epoch=self._ep(src)).encode())
        self._ack_due.clear()

    def arq_unacked(self) -> int:
        """Outstanding reliable frames not yet covered by an ACK."""
        return sum(len(q) for q in self._tx_unacked.values())

    # ------------------------------------------------------------------
    # Metrics registry (docs/DESIGN.md §7). Counter keys, nesting, and
    # histogram layout are IDENTICAL to the C engine's rlo_engine_stats
    # (bindings.NativeEngine.metrics()) — asserted by the metrics-parity
    # test — so dashboards and tests consume one schema.
    # ------------------------------------------------------------------
    def enable_metrics(self, on: bool = True) -> None:
        """Turn on per-link frame/byte/RTT accounting and op-latency
        histograms. Off (the default), the residual cost is one branch
        per send/receive; counters (ARQ, bcast/pickup totals) are plain
        int increments and always live."""
        self._mx_on = bool(on)

    def enable_profiler(self, on: bool = True) -> None:
        """Turn on the in-engine phase profiler (docs/DESIGN.md §10):
        per-stage duration histograms over the ENGINE_PHASE_KEYS
        taxonomy, snapshot under ``metrics()["phases"]`` and mirrored
        by the C engine's rlo_phase_stats. Off (the default), every
        instrumented site costs exactly one predictable branch — no
        clock read, no histogram touch (the overhead contract). With
        the tracer live, every sample also lands in the Chrome
        timeline as an Ev.PHASE duration slice."""
        self._prof_on = bool(on)

    def metrics(self) -> dict:
        """Snapshot the engine's metrics as a nested dict (JSON-ready):
        ``counters`` (monotone totals incl. the ARQ counters),
        ``queues`` (live depths; ``pickup`` + ``wait_and_pickup`` is
        the pickup backlog), ``links`` (per-peer tx/rx frames+bytes,
        retransmits, dup drops, ack-measured RTT EWMA; all peers
        present, zeros when metrics are off), ``op_latency_usec``
        (bcast init->fan-out-complete, proposal submit->decision,
        frame receipt->pickup), and ``phases`` (the in-engine phase
        profiler's per-stage duration histograms over
        ENGINE_PHASE_KEYS; all zeros while the profiler is off)."""
        links = {}
        for peer in range(self.world_size):
            if peer == self.rank:
                continue
            ls = self._mx_link.get(peer)
            # string peer keys: the in-memory dict and its JSON
            # round-trip (benchmarks emit snapshots) share one schema
            links[str(peer)] = ls.snapshot() if ls is not None \
                else LinkStats().snapshot()
        vals = {
            "sent_bcast": self.sent_bcast_cnt,
            "recved_bcast": self.recved_bcast_cnt,
            "total_pickup": self.total_pickup,
            "ops_failed": self.ops_failed,
            "arq_retransmits": self.arq_retransmits,
            "arq_dup_drops": self.arq_dup_drops,
            "arq_gave_up": self.arq_gave_up,
            "arq_unacked": self.arq_unacked(),
            "epoch": self.epoch,
            "epoch_quarantined": self.epoch_quarantined,
            "rejoins": self.rejoins,
            "view_changes": self.view_changes,
            "reflood_frames": self.reflood_frames,
            "epoch_lag_max": self.epoch_lag_max,
            "quar_mid_rejoin": self.quar_mid_rejoin,
            "quar_failed_sender": self.quar_failed_sender,
            "quar_below_floor": self.quar_below_floor,
            "admission_rounds": self.admission_rounds,
            "epoch_syncs": self.epoch_syncs,
            "reflood_skipped": self.reflood_skipped,
            "batched_admits": self.batched_admits,
        }
        # the phase-profiler schema contract with the C engine: literal
        # keys here, ENGINE_PHASE_KEYS, and the rlo_phase_stats field
        # order are pinned to each other by rlo-lint R2 (the parity
        # test asserts snapshot equality at runtime)
        phs = {
            "frame_encode": self._ph["frame_encode"].snapshot(),
            "frame_decode": self._ph["frame_decode"].snapshot(),
            "send": self._ph["send"].snapshot(),
            "arq_scan": self._ph["arq_scan"].snapshot(),
            "tag_dispatch": self._ph["tag_dispatch"].snapshot(),
            "pickup_drain": self._ph["pickup_drain"].snapshot(),
            "bcast_first_fwd": self._ph["bcast_first_fwd"].snapshot(),
            "bcast_all_delivered":
                self._ph["bcast_all_delivered"].snapshot(),
            "prop_votes_aggregated":
                self._ph["prop_votes_aggregated"].snapshot(),
            "prop_decision": self._ph["prop_decision"].snapshot(),
        }
        return {
            # ENGINE_COUNTER_KEYS is the schema contract with the C
            # engine (bindings.NativeEngine.metrics builds from the
            # same tuple; the parity test asserts dict equality)
            "counters": {k: vals[k] for k in ENGINE_COUNTER_KEYS},
            "queues": {
                "wait": len(self.queue_wait),
                "pickup": len(self.queue_pickup),
                "wait_and_pickup": len(self.queue_wait_and_pickup),
                "iar_pending": len(self.queue_iar_pending),
            },
            "links": links,
            "op_latency_usec": {
                "bcast_complete": self._h_bcast.snapshot(),
                "proposal_resolve": self._h_prop.snapshot(),
                "pickup_wait": self._h_pickup.snapshot(),
            },
            "phases": {k: phs[k] for k in ENGINE_PHASE_KEYS},
        }

    # ------------------------------------------------------------------
    # Rootless broadcast (~RLO_bcast_gen, rootless_ops.c:1581-1604)
    # ------------------------------------------------------------------
    def bcast(self, payload: bytes, tag: Tag = Tag.BCAST,
              pid: int = -1, vote: int = -1,
              deadline: Optional[float] = None) -> _Msg:
        """Initiate a broadcast from this rank — no pre-designated root."""
        if Tag(tag) not in BCAST_TAGS:
            raise ValueError(
                f"tag {Tag(tag).name} is not store-and-forward; only "
                f"{sorted(t.name for t in BCAST_TAGS)} may be broadcast")
        if len(payload) > self.msg_size_max:
            raise ValueError(
                f"payload {len(payload)}B exceeds msg_size_max "
                f"{self.msg_size_max}B")
        if Tag(tag) == Tag.BCAST:
            # the vote field of plain broadcasts belongs to the
            # exactly-once sequence stamp now; a caller-supplied value
            # would be misread by receivers as a (likely already-seen)
            # seq and silently dropped cluster-wide
            if vote != -1:
                raise ValueError(
                    "Tag.BCAST frames carry the exactly-once sequence "
                    "number in the vote field; pass payload data in the "
                    "payload, not vote")
            vote = self._bcast_seq
            self._bcast_seq += 1
        frame = Frame(origin=self.rank, pid=pid, vote=vote, payload=payload)
        if self._prof_on:
            t0 = self.clock()
            raw = frame.encode()
            self._phobs("frame_encode", t0)
        else:
            raw = frame.encode()
        if Tag(tag) in (Tag.BCAST, Tag.IAR_DECISION, Tag.ABORT,
                        Tag.FAILURE):
            # decisions join the re-flood log: a decision lost in a
            # view-change window would otherwise leave relayed rounds
            # parked forever (blocking checkpoint) — the settled-set
            # dedup absorbs the flood exactly like (origin, seq) does
            # for broadcasts. Aborts ride the same log for the same
            # reason: an abort lost with a dead relay would leave the
            # aborted round parked at its descendants. Failure
            # declarations ride it too (docs/DESIGN.md §8) — receivers
            # suppress known failures, and admission purges the log of
            # stale notices about the readmitted rank.
            self._recent_bcasts.append((int(tag), raw))
        msg = _Msg(frame=frame, tag=int(tag))
        if deadline is None:
            deadline = self.op_deadline
        if deadline is not None:
            msg.deadline = self.clock() + deadline
        if Tag(tag) == Tag.BCAST and (self._mx_on or self._prof_on):
            now = self.clock()
            if self._mx_on:
                msg.born = now
            if self._prof_on:
                msg.p_born = now
        for dst in self._cur_initiator_targets():  # furthest-first
            msg.send_handles.append(self._send_raw(dst, int(tag), raw))
        self.queue_wait.append(msg)
        self.sent_bcast_cnt += 1
        TRACER.emit(self.rank, Ev.BCAST_INIT, int(tag), len(payload),
                    _trace_ident(Tag(tag), frame))
        self.manager.progress_all()
        return msg

    # ------------------------------------------------------------------
    # IAR leaderless consensus (~rootless_ops.c:668-932)
    # ------------------------------------------------------------------
    def submit_proposal(self, proposal: bytes, pid: int,
                        deadline: Optional[float] = None) -> int:
        """Propose; every rank judges; AND-aggregated votes come back up the
        reverse broadcast tree; we then broadcast the decision
        (~RLO_submit_proposal, rootless_ops.c:876-906).

        Returns the decision if it completed within this call's progress
        turn, else -1 (poll with check_proposal_state / vote_my_proposal).

        ``deadline`` (seconds, relative; default ``op_deadline``): if the
        round has not resolved by then, the proposal transitions to
        ReqState.FAILED and a rootless Tag.ABORT broadcast unparks the
        round at every relay — the op completes or fails
        deterministically instead of hanging on a lost vote.
        """
        p = self.my_own_proposal
        if p.state == ReqState.IN_PROGRESS:
            raise RuntimeError(
                f"rank {self.rank}: proposal pid={p.pid} is still in "
                f"progress; wait for completion before submitting another")
        p.pid = pid
        if deadline is None:
            deadline = self.op_deadline
        p.deadline = None if deadline is None else self.clock() + deadline
        # rank-qualified (counter * world_size + rank) so two proposers
        # reusing one pid can never collide on generation either, with
        # no overflow for any realistic rank count or round count
        p.gen = self._gen_next * self.world_size + self.rank
        self._gen_next += 1
        p.vote = 1
        p.await_from = list(self._cur_initiator_targets())
        p.votes_needed = len(p.await_from)
        p.votes_recved = 0
        p.state = ReqState.IN_PROGRESS
        p.decision_handles = []
        p.decision_pending = False
        self.my_proposal_payload = bytes(proposal)
        if self._mx_on:
            self._prop_born = self.clock()
        if self._prof_on:
            self._p_prop_born = self.clock()
        TRACER.emit(self.rank, Ev.PROPOSAL_SUBMIT, pid, 0, p.gen)
        # the proposal frame's vote field carries the round generation
        # (the reference leaves it at the initial vote 1, :888)
        self.bcast(proposal, tag=Tag.IAR_PROPOSAL, pid=pid, vote=p.gen)
        if p.votes_needed == 0 and p.state == ReqState.IN_PROGRESS \
                and not p.decision_pending:
            # no awaited voters (sole survivor after elastic
            # re-forming): nothing will ever call _on_vote
            self._complete_own_proposal(p)
            self.manager.progress_all()
        if p.state == ReqState.COMPLETED:
            return p.vote
        return -1

    def check_proposal_state(self) -> ReqState:
        """~RLO_check_proposal_state (rootless_ops.c:869-872)."""
        self.manager.progress_all()
        return self.my_own_proposal.state

    def vote_my_proposal(self) -> int:
        """Decision for my own proposal: -1 incomplete, 0 declined,
        1 approved (~RLO_get_vote_my_proposal, rootless_ops.c:1666-1673)."""
        self.manager.progress_all()
        if self.my_own_proposal.state != ReqState.COMPLETED:
            return -1
        return self.my_own_proposal.vote

    # ------------------------------------------------------------------
    # Fabric-facing surface (docs/DESIGN.md §11): post-construction
    # callback wiring, reliable point-to-point user frames, and the
    # rejoin-state probe the serving layer gates its pump on.
    # ------------------------------------------------------------------
    def set_app(self, judge_cb: Optional[JudgeCb] = None,
                action_cb: Optional[ActionCb] = None,
                app_ctx: object = None):
        """Swap the application callbacks after construction (the
        serving fabric attaches to an engine the harness already
        built). Returns the previous ``(judge_cb, action_cb,
        app_ctx)`` triple so a layered consumer can chain to it."""
        prev = (self.judge_cb, self.action_cb, self.app_ctx)
        self.judge_cb = judge_cb
        self.action_cb = action_cb
        self.app_ctx = app_ctx
        return prev

    def send_direct(self, dst: int, payload: bytes,
                    tag: Tag = Tag.SERVE, pid: int = -1,
                    vote: int = -1) -> SendHandle:
        """Reliable point-to-point user frame: goes through the normal
        send gate (link-epoch stamp; ARQ seq + retransmit-until-acked
        when ARQ is on) and is delivered at the destination via
        ``pickup_next`` (the ``_on_other`` route). Only user-routable
        tags are accepted — engine-internal tags would corrupt
        protocol state at the receiver."""
        if Tag(tag) not in DIRECT_TAGS:
            raise ValueError(
                f"tag {Tag(tag).name} is engine-internal; direct sends "
                f"allow {sorted(t.name for t in DIRECT_TAGS)}")
        if len(payload) > self.msg_size_max:
            raise ValueError(
                f"payload {len(payload)}B exceeds msg_size_max "
                f"{self.msg_size_max}B")
        if not 0 <= dst < self.world_size or dst == self.rank:
            raise ValueError(f"bad destination rank {dst}")
        h = self._send_raw(dst, int(tag),
                           Frame(origin=self.rank, pid=pid, vote=vote,
                                 payload=payload).encode())
        self.manager.progress_all()
        return h

    @property
    def mid_rejoin(self) -> bool:
        """True while this engine is a joiner awaiting its
        JOIN_WELCOME (it quarantines all non-membership traffic and
        its peers quarantine its frames — docs/DESIGN.md §8); the
        serving fabric suspends its pump until admission."""
        return self._awaiting_welcome

    # ------------------------------------------------------------------
    # Delivery (~RLO_user_pickup_next / RLO_user_msg_recycle,
    # rootless_ops.c:938-992)
    # ------------------------------------------------------------------
    def pickup_next(self) -> Optional[UserMsg]:
        """Next delivered message, or None. Messages still forwarding are
        eligible (wait_and_pickup first, then pickup — reference order)."""
        t0 = self.clock() if self._prof_on else None
        if self.queue_wait_and_pickup:
            msg = self.queue_wait_and_pickup.pop(0)
            msg.pickup_done = True
            self.queue_wait.append(msg)  # keep tracking its forwards
            out = self._deliver(msg)
        elif self.queue_pickup:
            msg = self.queue_pickup.popleft()
            msg.pickup_done = True
            out = self._deliver(msg)
        else:
            return None
        if t0 is not None:
            self._phobs("pickup_drain", t0)
        return out

    def _deliver(self, msg: _Msg) -> UserMsg:
        self.total_pickup += 1
        if msg.arrived is not None:
            self._h_pickup.observe((self.clock() - msg.arrived) * 1e6)
        if TRACER.enabled:
            TRACER.emit(self.rank, Ev.DELIVER, msg.tag, msg.frame.origin,
                        _trace_ident(msg.tag, msg.frame), msg.src)
            # wire-hop receipt marker for a sampled request riding this
            # payload (span-context trailer, docs/DESIGN.md §19): b=-1
            # distinguishes the hop from a stage-boundary span
            pl = msg.frame.payload
            if len(pl) >= SPAN_CTX_SIZE:
                span = decode_span_ctx(pl, len(pl) - SPAN_CTX_SIZE)
                if span is not None:
                    TRACER.emit(self.rank, Ev.SPAN, span[1], -1,
                                span[3], span[2],
                                ts_usec=int(self.clock() * 1e6))
        return self._to_user(msg)

    @staticmethod
    def _to_user(msg: _Msg) -> UserMsg:
        f = msg.frame
        return UserMsg(type=msg.tag, origin=f.origin, pid=f.pid,
                       vote=f.vote, data=f.payload)

    # ------------------------------------------------------------------
    # The gear (~make_progress_gen, rootless_ops.c:551-641)
    # ------------------------------------------------------------------
    def _progress_once(self) -> None:
        # (a) my own decision broadcast completion -> proposal COMPLETED;
        # deadline expiry -> FAILED + rootless ABORT (op-deadline
        # machinery: the op terminates deterministically either way)
        p = self.my_own_proposal
        if p.state == ReqState.IN_PROGRESS and p.decision_pending:
            if all(h.done() for h in p.decision_handles):
                p.state = ReqState.COMPLETED
                p.decision_pending = False
                if self._prop_born is not None:
                    self._h_prop.observe(
                        (self.clock() - self._prop_born) * 1e6)
                    self._prop_born = None
                if self._p_prop_born is not None:
                    # submit -> decision fan-out complete (§10 phase)
                    self._phobs("prop_decision", self._p_prop_born)
                    self._p_prop_born = None
        if (p.state == ReqState.IN_PROGRESS and not p.decision_pending
                and p.deadline is not None
                and self.clock() > p.deadline):
            self._abort_own_proposal(p)

        # (b) drain the transport, dispatch on tag
        while True:
            item = self.transport.poll()
            if item is None:
                break
            src, tag, raw = item
            if self._prof_on:
                t0 = self.clock()
                frame = Frame.decode(raw)
                self._phobs("frame_decode", t0)
            else:
                frame = Frame.decode(raw)
            msg = _Msg(frame=frame, tag=tag, src=src)
            if self._mx_on:
                if 0 <= src < self.world_size:
                    ls = self._link(src)
                    ls.rx_frames += 1
                    ls.rx_bytes += len(raw)
                msg.arrived = self.clock()
            # membership frames cross the boundaries the quarantine
            # below enforces — dispatch them first (docs/DESIGN.md §8)
            if tag in EPOCH_EXEMPT_TAGS:
                if tag == Tag.JOIN:
                    self._on_join(msg)
                elif tag == Tag.JOIN_WELCOME:
                    self._on_welcome(msg)
                elif tag == Tag.MSYNC:
                    self._on_msync(msg)
                continue
            # stale-epoch / failed-sender quarantine, BEFORE ACK
            # handling and the ARQ dedup: a dead incarnation's traffic
            # (and everything while this rank is itself mid-rejoin)
            # must not touch link state, liveness, or app state
            if self._awaiting_welcome:
                self.epoch_quarantined += 1
                self.quar_mid_rejoin += 1
                continue
            if 0 <= src < self.world_size:
                if src in self.failed:
                    self.epoch_quarantined += 1
                    self.quar_failed_sender += 1
                    continue
                floor = self._epoch_floor.get(src)
                if floor is not None and msg.frame.epoch < floor:
                    self.epoch_quarantined += 1
                    self.quar_below_floor += 1
                    # stale-sender nack: an ALIVE sender stamping
                    # below our floor missed its welcome — show it
                    # the winning view so it re-petitions (closes the
                    # lost-JOIN_WELCOME race: no heal probe fires at
                    # it because neither side holds the other failed)
                    now = self.clock()
                    if now - self._stale_probe_last.get(
                            src, float("-inf")) >= self.join_interval:
                        self._stale_probe_last[src] = now
                        self._send_join_probe(src)
                    continue
                # heal-cost signal (docs/DESIGN.md §17): how far my
                # view epoch has outrun the link-epoch stamp of frames
                # I still ACCEPT — a laggard edge (its last link reset
                # predates recent view churn) shows up as growing lag
                lag = self.epoch - msg.frame.epoch
                if lag > self.epoch_lag_max:
                    self.epoch_lag_max = lag
            if self.failure_timeout is not None and 0 <= src < \
                    self.world_size:
                # ANY accepted frame proves the sender alive — under
                # heavy traffic this prevents heartbeat starvation when
                # membership views transiently diverge (each view picks
                # different ring successors)
                self._hb_seen[src] = self.clock()
            if tag == Tag.ACK:
                if msg.frame.vote == -2 and msg.frame.pid >= 0:
                    # SKIP notice: the sender gave up on everything
                    # <= pid; advance the watermark over the hole
                    self._rx_skip(src, msg.frame.pid)
                else:
                    self._on_ack(src, msg.frame.vote)
                continue
            if self.arq_rto is not None and tag not in ARQ_EXEMPT_TAGS \
                    and msg.frame.seq >= 0:  # IntEnum: raw ints hash in
                # link-level exactly-once BEFORE tag dispatch: a
                # retransmitted frame must be idempotent everywhere
                # (dup suppression), and its receipt owes the sender a
                # cumulative ACK either way
                self._ack_due.add(src)
                if self._rx_is_dup(src, msg.frame.seq):
                    self.arq_dup_drops += 1
                    if self._mx_on:
                        self._link(src).dup_drops += 1
                    continue
            # §10 tag_dispatch phase: dispatch + handler for one
            # protocol frame (quarantine/ACK/dedup exits above are not
            # counted — they never reach a handler)
            t_disp = self.clock() if self._prof_on else None
            if tag == Tag.BCAST:
                self.recved_bcast_cnt += 1
                if self._bcast_is_dup(msg):
                    continue  # exactly-once: drop, don't re-forward
                self._recent_bcasts.append((int(tag), raw))
                self._bc_forward(msg)
            elif tag == Tag.IAR_PROPOSAL:
                self._on_proposal(msg)
            elif tag == Tag.IAR_VOTE:
                self._on_vote(msg)
            elif tag == Tag.IAR_DECISION:
                self.recved_bcast_cnt += 1
                self._on_decision(msg)
            elif tag == Tag.HEARTBEAT:
                # liveness already refreshed above for any frame; a
                # piggybacked cumulative ACK rides the payload
                if self.arq_rto is not None and \
                        len(msg.frame.payload) >= 4:
                    self._on_ack(src, struct.unpack_from(
                        "<i", msg.frame.payload)[0])
            elif tag == Tag.FAILURE:
                self._on_failure(msg)
            elif tag == Tag.ABORT:
                self._on_abort(msg)
            else:
                self._on_other(msg)
            if t_disp is not None:
                self._phobs("tag_dispatch", t_disp)

        # (b2) liveness: heartbeat my ring successor, watch my
        # predecessor — suspended while mid-rejoin (a joiner
        # quarantines everything, so its detector would only produce
        # false declarations against peers it cannot hear)
        if self.failure_timeout is not None and \
                not self._awaiting_welcome:
            self._failure_tick()

        # (b2b) membership: JOIN petitions (joiner side), heal probes
        # at failed-but-maybe-alive peers, and queued admission rounds
        # waiting for the own-proposal slot (docs/DESIGN.md §8)
        if self._awaiting_welcome or self._pending_joins or \
                len(self.failed) > len(self._sub_excluded):
            # (len compare: _sub_excluded is always a subset of
            # failed, and the set difference would allocate per tick)
            self._membership_tick()

        # (b3) reliable delivery: retransmit overdue unacked frames,
        # then flush the cumulative ACKs this turn's receipts owe
        if self.arq_rto is not None:
            if self._prof_on:
                t0 = self.clock()
                self._arq_tick()
                self._phobs("arq_scan", t0)
            else:
                self._arq_tick()
            self._flush_acks()

        # (c) wait_and_pickup sweep (~_wait_and_pickup_queue_process :995).
        # Messages here are never picked up (pickup_next moves them to
        # queue_wait when it claims them), so completion always delivers.
        for msg in list(self.queue_wait_and_pickup):
            if msg.sends_done():
                msg.fwd_done = True
                if msg.state == ReqState.IN_PROGRESS:
                    msg.state = ReqState.COMPLETED
                self.queue_wait_and_pickup.remove(msg)
                self.queue_pickup.append(msg)
            elif msg.deadline is not None and self.clock() > msg.deadline:
                # op deadline: abandon the forwards but still deliver
                # locally (the payload arrived here; only the fan-out
                # is past deadline)
                msg.state = ReqState.FAILED
                self.ops_failed += 1
                msg.fwd_done = True
                self.queue_wait_and_pickup.remove(msg)
                self.queue_pickup.append(msg)

        # (d) wait-only sweep (~_wait_only_queue_cleanup :1015)
        for msg in list(self.queue_wait):
            if msg.p_born is not None and not msg.first_fwd and \
                    any(h.done() for h in msg.send_handles):
                # §10 bcast_first_fwd: init -> the FIRST fan-out send
                # completed (the earliest handoff to a peer); observed
                # once per locally-initiated broadcast
                msg.first_fwd = True
                self._phobs("bcast_first_fwd", msg.p_born)
            if msg.sends_done():
                msg.fwd_done = True
                if msg.state == ReqState.IN_PROGRESS:
                    msg.state = ReqState.COMPLETED
                if msg.born is not None:
                    # locally-initiated bcast: init -> fan-out complete
                    self._h_bcast.observe(
                        (self.clock() - msg.born) * 1e6)
                if msg.p_born is not None:
                    self._phobs("bcast_all_delivered", msg.p_born)
                self.queue_wait.remove(msg)
            elif msg.deadline is not None and self.clock() > msg.deadline:
                # op deadline: stop tracking — the op FAILED
                # deterministically instead of parking forever on a
                # handle that will never complete
                msg.state = ReqState.FAILED
                self.ops_failed += 1
                msg.fwd_done = True
                self.queue_wait.remove(msg)

    def _bc_forward_only(self, msg: _Msg) -> None:
        """Forward a duplicate store-and-forward frame along the overlay
        without any local processing/delivery; the wait-only queue frees
        it once the sends complete."""
        origin = msg.frame.origin
        raw = None
        for dst in self._fwd_targets(origin, msg.src):
            if raw is None:
                raw = msg.frame.encode()
            msg.send_handles.append(self._send_raw(dst, msg.tag, raw))
        self.queue_wait.append(msg)

    def _bcast_is_dup(self, msg: _Msg) -> bool:
        """Exactly-once receipt check for Tag.BCAST frames, keyed on
        (origin, seq). The initiator never delivers its own broadcast,
        so a re-flooded copy of my own frame is also a duplicate."""
        origin, seq = msg.frame.origin, msg.frame.vote
        if origin == self.rank:
            return True
        if seq < 0:
            return False  # unstamped (foreign/legacy frame): best-effort
        return self._window_record(
            self._seen_bcast.setdefault(origin, [-1, set()]), seq)

    # -- broadcast forwarding (~_bc_forward, rootless_ops.c:1104-1225) ----
    def _bc_forward(self, msg: _Msg) -> int:
        origin = msg.frame.origin
        targets = self._fwd_targets(origin, msg.src)
        raw = None
        for dst in targets:
            if raw is None:
                if self._prof_on:
                    t0 = self.clock()
                    raw = msg.frame.encode()
                    self._phobs("frame_encode", t0)
                else:
                    raw = msg.frame.encode()
            msg.send_handles.append(self._send_raw(dst, msg.tag, raw))
        # receipt+forward step — emitted even for leaf receipts (zero
        # targets) so the timeline merger always has a receive-side
        # anchor carrying (origin, identity, immediate sender)
        if TRACER.enabled:
            TRACER.emit(self.rank, Ev.BCAST_FWD, msg.tag, origin,
                        _trace_ident(msg.tag, msg.frame), msg.src)

        if msg.tag == Tag.IAR_PROPOSAL:
            # proposals are engine-internal: parked for the decision, never
            # user-visible (make_progress_gen :591-596)
            self.queue_iar_pending.append(msg)
        elif msg.tag == Tag.IAR_DECISION:
            # decision delivery handled by _on_decision
            pass
        else:
            if targets:
                self.queue_wait_and_pickup.append(msg)
            else:
                msg.fwd_done = True
                self.queue_pickup.append(msg)
        return len(targets)

    # -- IAR handlers (~rootless_ops.c:668-859) ---------------------------
    def _judge(self, payload: bytes, pid: int) -> int:
        if payload.startswith(MEMBER_MAGIC):
            # internal membership admission round (docs/DESIGN.md §8):
            # the engine judges it itself — the app's judge never sees
            # protocol-internal rounds
            verdict = 1
        elif self.judge_cb is None:
            verdict = 1
        else:
            verdict = int(self.judge_cb(payload, self.app_ctx))
        TRACER.emit(self.rank, Ev.JUDGE, pid, verdict)
        return verdict

    def _vote_back(self, ps: ProposalState, vote: int) -> None:
        """Send my (merged) vote to the rank I got the proposal from
        (~_vote_back :728-741, nonblocking here). The payload echoes the
        round generation so a stale vote from an earlier same-pid round
        can never be counted into a later one."""
        frame = Frame(origin=self.rank, pid=ps.pid, vote=int(vote),
                      payload=struct.pack("<i", ps.gen))
        self._send(ps.recv_from, int(Tag.IAR_VOTE), frame)
        TRACER.emit(self.rank, Ev.VOTE, ps.pid, int(vote), ps.gen)

    def _resolve_relay(self, ps: ProposalState) -> None:
        """The relay's merged vote is final: send it to the vote-tree
        parent AND to every duplicate parent acquired from re-formed
        overlay trees. Sending one merged verdict everywhere (instead
        of an interim verdict at duplicate-arrival time) is what
        guarantees a subtree veto can never be lost when the original
        parent is the dead rank that triggered the view change
        (found in review: the optimistic interim vote approved
        a round whose veto went to a blackhole)."""
        ps.resolved = True
        self._vote_back(ps, ps.vote)
        for dp in ps.dup_parents:
            self._vote_back(ProposalState(pid=ps.pid, gen=ps.gen,
                                          recv_from=dp), ps.vote)
        ps.dup_parents.clear()

    def _on_proposal(self, msg: _Msg) -> None:
        """~_iar_proposal_handler (:668-726)."""
        origin = msg.frame.origin
        if origin == self.rank:
            # my own proposal echoed back around a re-formed overlay
            # cycle (mixed views while membership converges): the
            # proposer holds no relay state and must not re-forward
            return
        # duplicate across a view change (mixed old/new overlay trees):
        # never re-judge or re-park — a second ProposalState voting to a
        # second parent would corrupt the vote accounting. Forward for
        # coverage (a descendant may be reachable only via this tree).
        # A PENDING duplicate's sender is a live relay awaiting my vote
        # (its await_from was built from its own forward list), so it
        # must eventually hear from me — but my subtree's veto may
        # still be in flight, so an interim verdict could approve a
        # round a live rank vetoed. Resolved round: the merged vote is
        # final, send it now. Unresolved: record the sender as a
        # duplicate parent; _resolve_relay sends it the merged vote.
        # A SETTLED duplicate needs no vote (the decision already
        # broadcast; on_decision frees the sender's pending state).
        gen = msg.frame.vote
        pending = self._find_proposal_msg(msg.frame.pid, gen)
        if pending is not None or (msg.frame.pid, gen) in \
                self._settled_set:
            if pending is not None:
                ps = pending.prop_state
                if msg.src != ps.recv_from and \
                        msg.src not in ps.dup_parents:
                    if ps.resolved:
                        self._vote_back(
                            ProposalState(pid=ps.pid, gen=gen,
                                          recv_from=msg.src), ps.vote)
                    else:
                        ps.dup_parents.append(msg.src)
            self._bc_forward_only(msg)
            return
        if (self.my_own_proposal.state == ReqState.IN_PROGRESS
                and msg.frame.pid == self.my_own_proposal.pid):
            # pid collision with my active proposal — the reference only
            # printf-warns here (rootless_ops.c:690-692) and then corrupts
            # vote accounting; fail loudly instead
            raise RuntimeError(
                f"rank {self.rank}: received a proposal with the pid of my "
                f"own active proposal ({msg.frame.pid}); pids must be "
                f"unique across concurrent proposers")
        # equal to _bc_forward's target list by construction, including
        # after elastic re-forming (~fwd_send_cnt :1559)
        children = list(self._fwd_targets(origin, msg.src))
        ps = ProposalState(
            pid=msg.frame.pid,
            gen=msg.frame.vote,  # round generation (see submit_proposal)
            recv_from=msg.src,
            state=ReqState.IN_PROGRESS,
            proposal_payload=msg.frame.payload,
            votes_needed=len(children),
            await_from=children,
        )
        msg.prop_state = ps
        judgment = self._judge(msg.frame.payload, ps.pid)
        if judgment == 0:
            # decline: vote NO to parent immediately, do not forward —
            # the subtree below never sees the proposal, only the
            # decision. Parked anyway (resolved, vote 0) so duplicates
            # from re-formed trees find the verdict instead of
            # re-judging, and an approved decision (possible when this
            # veto was discounted with a dead subtree) still fires the
            # action callback here like everywhere else. The children
            # never saw the proposal: clear the await list so a later
            # child failure cannot re-trigger resolution (C mirror
            # zeroes n_await the same way)
            ps.vote = 0
            ps.votes_needed = 0
            ps.await_from = []
            self._resolve_relay(ps)
            self.queue_iar_pending.append(msg)
        else:
            sent = self._bc_forward(msg)  # parks msg in queue_iar_pending
            if sent == 0:
                self._resolve_relay(ps)  # leaf: merged vote == my own

    def _on_vote(self, msg: _Msg) -> None:
        """~_iar_vote_handler (:743-812). Votes AND-merge upward."""
        pid, vote = msg.frame.pid, msg.frame.vote
        gen = struct.unpack_from("<i", msg.frame.payload)[0] \
            if len(msg.frame.payload) >= 4 else -1
        p = self.my_own_proposal
        # claim the vote for my own proposal ONLY while it is in
        # progress AND the generations match: a later proposer may
        # legitimately reuse this pid (collisions are only forbidden
        # between CONCURRENT proposals), and a stale vote from an
        # earlier same-pid round must never merge into a newer one
        if pid == p.pid and p.state == ReqState.IN_PROGRESS \
                and gen == p.gen:
            # only votes from children still awaited count: a vote from
            # a discounted (suspected-dead) child must not advance the
            # count past a live child's pending veto
            if msg.src not in p.await_from:
                return
            p.await_from.remove(msg.src)
            p.votes_recved += 1
            p.vote &= vote
            if p.votes_recved == p.votes_needed:
                self._complete_own_proposal(p)
            return
        # vote for a proposal I'm relaying — matched on (pid, gen) so
        # two queued rounds reusing one pid can never shadow each other
        pm = self._find_proposal_msg(pid, gen)
        if pm is None:
            if (pid == p.pid and p.state != ReqState.INVALID) or \
                    (pid, gen) in self._settled_set or \
                    self.failure_timeout is not None or self.failed:
                # stale round / settled-or-aborted round / view change
                return
            raise RuntimeError(
                f"rank {self.rank}: vote for unknown proposal pid={pid}")
        ps = pm.prop_state
        if msg.src not in ps.await_from:
            return  # late/duplicate vote from a discounted child
        ps.await_from.remove(msg.src)
        ps.vote &= vote
        ps.votes_recved += 1
        if ps.votes_recved == ps.votes_needed:
            self._resolve_relay(ps)

    def _complete_own_proposal(self, p: ProposalState) -> None:
        if self._p_prop_born is not None:
            # §10 prop_votes_aggregated: submit -> every awaited vote
            # merged (or discounted); the decision fan-out starts here
            self._phobs("prop_votes_aggregated", self._p_prop_born)
        if p.vote:
            # re-judge own proposal: a competing proposal may have
            # changed the app state since submission (:773)
            p.vote = self._judge(self.my_proposal_payload, p.pid)
        self._decision_bcast(p)
        if p.pid <= MEMBER_PID_BASE:
            # membership round: the admitting proposer executes the
            # admission right after fanning the decision out (the
            # decision itself was routed over the PRE-admission
            # member-only overlay), then welcomes + replays to the
            # joiner (docs/DESIGN.md §8)
            self._finish_member_round(p)

    def _decision_bcast(self, p: ProposalState) -> None:
        """Proposer broadcasts the final decision (~_iar_decision_bcast
        :908-917) — a regular rootless broadcast with the decision in the
        vote field and the round generation in the payload. Membership
        rounds append the admission record (MEMBER_MAGIC + agreed
        epoch + the batch of (joiner, incarnation) pairs) so every
        member can execute the admissions from the decision alone,
        even if it never saw the proposal (generation readers only
        unpack the first 4 bytes)."""
        payload = struct.pack("<i", p.gen)
        if p.pid <= MEMBER_PID_BASE:
            payload += self.my_proposal_payload
        msg = self.bcast(payload, tag=Tag.IAR_DECISION,
                         pid=p.pid, vote=p.vote)
        p.decision_handles = list(msg.send_handles)
        p.decision_pending = True
        TRACER.emit(self.rank, Ev.DECISION, p.pid, p.vote, p.gen)

    def _abort_own_proposal(self, p: ProposalState) -> None:
        """Deadline expired with votes still outstanding: the round
        FAILS deterministically. Mark FAILED (finally assigning the
        reference's dead RLO_FAILED for timeouts, not only dead
        proposers), then broadcast a rootless ABORT over the overlay so
        every relay unparks the round and the app learns the failure
        from pickup instead of hanging. Composes with elastic re-form:
        the pid is immediately free to resubmit on the survivor
        topology."""
        p.state = ReqState.FAILED
        self.ops_failed += 1
        self._prop_born = None  # resolve latency tracks successes only
        self._p_prop_born = None  # phase timers track successes only
        TRACER.emit(self.rank, Ev.DECISION, p.pid, -1, p.gen)
        if p.pid <= MEMBER_PID_BASE:
            # aborted admission round: free every batched joiner for a
            # retry (their next JOIN probes re-petition)
            adm = self._member_decode(self.my_proposal_payload)
            if adm is not None:
                for joiner, _inc in adm[1]:
                    self._admitting.discard(joiner)
        self.bcast(struct.pack("<i", p.gen), tag=Tag.ABORT, pid=p.pid)

    def _on_abort(self, msg: _Msg) -> None:
        """A proposer gave up on a round (deadline expiry): unpark the
        relayed proposal as FAILED, settle the (pid, gen) so late
        duplicates of the proposal are never re-parked, forward along
        the overlay, and deliver the abort notice to the user (pid =
        aborted pid) — the failure is delivered, not hung on."""
        pid = msg.frame.pid
        if msg.frame.origin == self.rank:
            return  # re-flooded copy of my own abort
        gen = struct.unpack_from("<i", msg.frame.payload)[0] \
            if len(msg.frame.payload) >= 4 else -1
        if gen >= 0:
            if (pid, gen) in self._settled_set:
                # duplicate (view-change trees / re-flood): forward for
                # coverage, deliver exactly once
                self._bc_forward_only(msg)
                return
            if len(self._settled_rounds) == self._settled_rounds.maxlen:
                self._settled_set.discard(self._settled_rounds[0])
            self._settled_rounds.append((pid, gen))
            self._settled_set.add((pid, gen))
            self._recent_bcasts.append((int(Tag.ABORT),
                                        msg.frame.encode()))
        pm = self._find_proposal_msg(pid, gen)
        if pid <= MEMBER_PID_BASE:
            # aborted membership round: engine-internal — unpark but
            # never deliver to the app; the joiner stays petitionable
            joiner = self._member_joiner(pid)
            if joiner is not None:
                self._admitting.discard(joiner)
            self._bc_forward_only(msg)
        else:
            self._bc_forward(msg)  # forwards AND queues for pickup
        if pm is not None:
            pm.prop_state.state = ReqState.FAILED
            self.queue_iar_pending.remove(pm)

    def _on_decision(self, msg: _Msg) -> None:
        """~_iar_decision_handler (:814-859) + forward along the overlay."""
        pid, vote = msg.frame.pid, msg.frame.vote
        if msg.frame.origin == self.rank:
            # a re-flooded copy of my own decision (the proposer learns
            # its decision from the vote merge, never from the wire)
            return
        gen = struct.unpack_from("<i", msg.frame.payload)[0] \
            if len(msg.frame.payload) >= 4 else -1
        if gen >= 0:  # ungenerated (foreign/legacy) frames: best-effort
            if (pid, gen) in self._settled_set:
                # duplicate across a view change: deliver exactly once,
                # but STILL forward — a descendant reachable only
                # through this second tree (its old-view parent died)
                # has no other way to learn the decision
                self._bc_forward_only(msg)
                return
            if len(self._settled_rounds) == self._settled_rounds.maxlen:
                self._settled_set.discard(self._settled_rounds[0])
            self._settled_rounds.append((pid, gen))
            self._settled_set.add((pid, gen))
            # log for view-change re-flooding (decisions must survive
            # the loss of any one relay — parked rounds depend on it)
            self._recent_bcasts.append((int(Tag.IAR_DECISION),
                                        msg.frame.encode()))
        pm = self._find_proposal_msg(pid, gen)
        self._bc_forward(msg)  # forward first; delivery below
        if pid <= MEMBER_PID_BASE:
            # membership round: engine-internal. Execute the admission
            # from the decision's embedded record (works even when
            # this rank never saw the proposal), unpark any relayed
            # round WITHOUT the app action, and never deliver to
            # pickup — but keep tracking the forward handles.
            if pm is not None:
                pm.prop_state.state = (ReqState.COMPLETED if vote
                                       else ReqState.FAILED)
                self.queue_iar_pending.remove(pm)
            adm = self._member_decode(msg.frame.payload[4:])
            if adm is not None:
                new_epoch, recs = adm
                for joiner, inc in recs:
                    self._admitting.discard(joiner)
                    self._pending_joins.pop(joiner, None)
                    if vote and self._execute_admission(
                            joiner, inc, new_epoch) and len(recs) > 1:
                        self.batched_admits += 1
            self.queue_wait.append(msg)
            return
        if pm is not None:
            if vote:
                # approved: execute the user action (:842) — on every
                # rank, including one that voted no (its veto may have
                # been discounted along with a dead subtree; agreement
                # means everyone follows the decision)
                if self.action_cb is not None:
                    self.action_cb(pm.prop_state.proposal_payload,
                                   self.app_ctx)
                pm.prop_state.state = ReqState.COMPLETED
            self.queue_iar_pending.remove(pm)
        # deliver the decision to the user either way (:852-854)
        self.queue_pickup.append(msg)

    # ------------------------------------------------------------------
    # Failure detection + elastic re-forming (net-new; the reference
    # defines RLO_FAILED, rootless_ops.h:66, but never assigns it and has
    # no timeouts/retry/rank-failure handling — SURVEY.md §5)
    #
    # Consistency contract: membership changes are NOT view-synchronous,
    # but Tag.BCAST delivery is **exactly-once** across them for any
    # broadcast whose initiator survives:
    #   - at-most-once by construction: every initiated frame carries a
    #     per-origin sequence number and receivers dedup on (origin,
    #     seq) before forwarding or delivering (_bcast_is_dup), so a
    #     broadcast forwarded by a mix of old- and new-topology trees
    #     can never deliver twice;
    #   - at-least-once by re-flooding: on every adopted view change,
    #     each survivor re-sends its recent-broadcast log point-to-point
    #     to every alive rank (_reflood_recent_bcasts), plugging the
    #     forwarding holes a dead relay left; the dedup layer absorbs
    #     the duplication this creates.
    # Bounds on the at-least-once leg (at-most-once is unconditional):
    #   - the re-flood log keeps the most recent 64 frames per rank
    #     (_recent_bcasts maxlen); a broadcast older than that at every
    #     survivor when the view change lands cannot be re-flooded —
    #     with >64 broadcasts outstanding per rank across a failure,
    #     delivery degrades to at-most-once for the evicted ones;
    #   - broadcasts whose *initiator* died mid-send are at-most-once
    #     (a frame the origin never handed any survivor is gone).
    # Consensus traffic is exactly-once too: duplicate proposals are
    # never re-judged (a pending duplicate's new parent receives the
    # accumulated verdict so its round stays live), duplicate
    # decisions deliver/act once per (pid, gen) while still forwarding
    # for coverage, and vote accounting uses (pid, generation)
    # matching + failure discounting throughout.
    # ------------------------------------------------------------------
    def _cur_initiator_targets(self):
        """Initiator send list over the current alive set. Identity to the
        static topology while nothing has failed."""
        if self.fanout == "flat":
            # depth-1 tree: everyone alive, directly (see __init__)
            return tuple(r for r in self._alive if r != self.rank)
        if not self.failed:
            return self.initiator_targets
        alive = self._alive
        if len(alive) < 2:
            return ()
        vt = topology.initiator_targets(len(alive), self._v[self.rank])
        return tuple(alive[v] for v in vt)

    def _fwd_targets(self, origin: int, src: int):
        """Forward targets over the current alive set. Messages routed by
        a pre-failure view (dead origin/sender) are delivered locally but
        not re-forwarded — survivors re-broadcast if they need fan-out."""
        if self.fanout == "flat":
            return ()  # the origin reached everyone; deliver only
        if not self.failed:
            return topology.fwd_targets(self.world_size, self.rank,
                                        origin, src)
        if origin in self.failed or src in self.failed:
            return ()
        alive = self._alive
        if len(alive) < 2:
            return ()
        vt = topology.fwd_targets(len(alive), self._v[self.rank],
                                  self._v[origin], self._v[src])
        return tuple(alive[v] for v in vt)

    def _ring_neighbors(self):
        # per-view cache: _alive is rebound (never mutated in place)
        # on every view change, so object identity is a correct — and
        # O(1) — staleness check; topology.ring_neighbors itself is an
        # O(n) list.index walk, too hot for every progress turn at
        # 10k simulated ranks
        if self._ring_view is not self._alive:
            self._ring_view = self._alive
            self._ring_nbrs = topology.ring_neighbors(self._alive,
                                                      self.rank)
        return self._ring_nbrs

    def _failure_tick(self) -> None:
        if len(self._alive) < 2:
            return
        now = self.clock()
        succ, pred = self._ring_neighbors()
        if now - self._hb_last_sent >= self.heartbeat_interval:
            # piggyback the cumulative link ACK for the successor: even
            # with no reverse data traffic, its retransmit queue to us
            # drains at heartbeat cadence
            hb_payload = (struct.pack("<i", self._rx_cum(succ))
                          if self.arq_rto is not None else b"")
            frame = Frame(origin=self.rank, payload=hb_payload,
                          epoch=self._ep(succ))
            self._isend_counted(succ, int(Tag.HEARTBEAT), frame.encode())
            self._hb_last_sent = now
            TRACER.emit(self.rank, Ev.HEARTBEAT, succ)
        seen = self._hb_seen.setdefault(pred, now)  # grace on first watch
        if now - seen > self.failure_timeout:
            self._declare_failed(pred)

    def _announce_failed(self, rank: int) -> bool:
        """Adopt + announce a failure THIS rank detected (heartbeat
        silence or ARQ give-up): mark, then tell the world — the
        notice rides the rootless broadcast overlay AND goes
        point-to-point to every alive rank (belt and braces: overlay
        forwarding can have holes while membership views are still
        converging; duplicate notices are suppressed at the receiver).
        Returns False when the failure was already known."""
        if not self._mark_failed(rank):
            return False
        # the vote field carries the DECLARER's epoch at declaration
        # time: unlike the header epoch (restamped on every re-flood/
        # retransmit) it is immutable, so receivers can recognize a
        # stale notice about a rank that was readmitted since
        self.bcast(b"", tag=Tag.FAILURE, pid=rank, vote=self.epoch)
        frame = Frame(origin=self.rank, pid=rank, vote=self.epoch)
        raw = frame.encode()
        for dst in self._alive:
            if dst != self.rank:
                self._send_raw(dst, int(Tag.FAILURE), raw)
        if self.failure_cb is not None:
            self.failure_cb(rank, True)
        return True

    def _declare_failed(self, rank: int) -> None:
        """Local heartbeat detection: capture the evidence, then adopt
        + announce via _announce_failed."""
        # capture the evidence BEFORE _mark_failed clears the slot: the
        # last-seen heartbeat age is what makes a false-positive
        # declaration diagnosable after the fact
        seen = self._hb_seen.get(rank)
        age = (self.clock() - seen) if seen is not None else float("inf")
        if not self._announce_failed(rank):
            return
        age_usec = (min(int(age * 1e6), 2**31 - 1)
                    if age != float("inf") else 2**31 - 1)
        logger.warning(
            "rank %d declaring rank %d FAILED: no heartbeat for "
            "%.1f ms (timeout %.1f ms, interval %.1f ms, alive now %s)",
            self.rank, rank, age * 1e3, self.failure_timeout * 1e3,
            self.heartbeat_interval * 1e3, self._alive)
        TRACER.emit(self.rank, Ev.FAILURE, rank, 1, age_usec)

    def _on_failure(self, msg: _Msg) -> None:
        """A FAILURE notification arrived: adopt the new membership BEFORE
        forwarding so the whole propagation runs on the survivor overlay,
        then deliver the notice to the user (pid = failed rank).
        Duplicates (the notice floods: overlay + direct sends) are
        dropped entirely — each failure is delivered exactly once."""
        rank = msg.frame.pid
        declared = msg.frame.vote  # declarer's epoch (-1 on legacy)
        if rank == self.rank:
            if 0 <= declared < self._welcome_epoch:
                return  # pre-rejoin leftover about my previous life
            # somebody declared me failed: the group has re-formed
            # without me and is quarantining my traffic, so record the
            # suspicion AND petition for readmission with JOIN probes
            # (docs/DESIGN.md §8 — rejoin replaces the old "no un-fail
            # protocol" dead end)
            if not self.suspected_self:
                self.suspected_self = True
                self._bc_forward(msg)
                # rlo-model: edge failure->joiner
                self._become_joiner()
            return
        if 0 <= declared < self._admit_epoch.get(rank, 0):
            # stale notice (declared before an admission we already
            # executed): adopting it would flap the fresh member out
            return
        fresh = self._mark_failed(rank)
        if not fresh:
            return  # already known: suppress the duplicate
        TRACER.emit(self.rank, Ev.FAILURE, rank, 0)
        self._bc_forward(msg)
        if self.failure_cb is not None:
            self.failure_cb(rank, False)

    def _mark_failed(self, rank: int) -> bool:
        """Adopt a failure into the membership view; returns False if it
        was already known (idempotent). Re-forms the virtual topology over
        the survivors — the elastic-recovery step."""
        if rank in self.failed or rank == self.rank or not (
                0 <= rank < self.world_size):
            return False
        old_pred = (self._ring_neighbors()[1]
                    if self.failure_timeout is not None
                    and len(self._alive) >= 2 else None)
        self.failed.add(rank)
        self._alive, self._v = topology.shared_view(
            tuple(r for r in self._alive if r != rank))
        self.group = self._alive
        self.view_changes += 1
        # every failure adoption bumps the membership epoch; the
        # sender-side floor (if it had rejoined before) is obsolete —
        # the failed-sender quarantine now covers it entirely
        self.epoch += 1
        self._epoch_floor.pop(rank, None)
        self._link_epoch.pop(rank, None)
        self._reset_epoch.pop(rank, None)
        self._pending_joins.pop(rank, None)
        self._hb_seen.pop(rank, None)
        # ARQ: a dead peer will never ack — stop retransmitting at it
        # (and stop owing it acks or skip notices)
        self._tx_unacked.pop(rank, None)
        self._tx_skip.pop(rank, None)
        self._ack_due.discard(rank)
        if self.failure_timeout is not None and len(self._alive) >= 2:
            # fresh grace period — but only when my predecessor actually
            # changed; re-arming an unchanged predecessor's timer on every
            # learned failure would let a correlated multi-failure defer
            # detection of an already-silent peer indefinitely
            _, pred = self._ring_neighbors()
            if pred != old_pred:
                self._hb_seen[pred] = self.clock()
        self._discount_failed_voter(rank)
        self._abort_orphaned_proposals(rank)
        self._reflood_recent_bcasts()
        return True

    def _reflood_recent_bcasts(self) -> None:
        """Plug forwarding holes a dead relay left — digest-scoped
        (docs/DESIGN.md §18). The earlier heal re-sent every recent
        BCAST/DECISION/ABORT/FAILURE frame point-to-point to every
        alive rank on every view change: O(log·n) frames per change,
        O(n²·ring) per churn episode, and the dominant term of the
        measured rejoin cascade. Now each view change sends one MSYNC
        advert per alive peer carrying only the log entries'
        IDENTITIES ((origin, seq) for broadcasts, (pid, gen) for
        decisions/aborts, (rank, declarer epoch) for failure notices);
        a peer answers with a WANT naming exactly the entries it
        provably misses, and only those payloads are re-sent (through
        the ARQ gate, with fresh link seqs). An empty log sends
        nothing at all — kill-only fleets heal for free. Delivery
        exactly-once still composes the same way: the WANT check reads
        the same dedup state ((origin, seq) windows + the settled
        ring) that would have dropped the blast's duplicates, and
        parent-died relayed rounds still stay parked because a relay
        missing a decision WANTs it (see _abort_orphaned_proposals).
        Adverts are best-effort (ARQ-exempt): every later view change
        re-adverts, and the admission replay / welcome path covers the
        rejoin side independently."""
        payload = self._advert_payload()
        if payload is None:
            return
        raw = Frame(origin=self.rank, payload=payload).encode()
        for dst in self._alive:
            if dst != self.rank:
                self._send_raw(dst, int(Tag.MSYNC), raw)

    def _log_entry_ident(self, tag: int, raw: bytes):
        """(tag, a, b) wire identity of one recent-log entry — the
        coordinates the advert/WANT pair exchanges instead of
        payloads. None for entries with no recoverable identity."""
        f = Frame.decode(raw)
        if tag == int(Tag.BCAST):
            return (tag, f.origin, f.vote)  # (origin, bcast seq)
        if tag in (int(Tag.IAR_DECISION), int(Tag.ABORT)):
            gen = struct.unpack_from("<i", f.payload)[0] \
                if len(f.payload) >= 4 else -1
            return (tag, f.pid, gen) if gen >= 0 else None
        if tag == int(Tag.FAILURE):
            return (tag, f.pid, f.vote)  # (failed rank, declarer epoch)
        return None

    def _advert_payload(self) -> Optional[bytes]:
        """MSYNC_AD payload for the current recent-broadcast log, or
        None when the log holds nothing advertisable."""
        idents = []
        for tag, raw in self._recent_bcasts:
            ident = self._log_entry_ident(tag, raw)
            if ident is not None:
                idents.append(ident)
        if not idents:
            return None
        out = bytearray(struct.pack("<Bi", MSYNC_AD, len(idents)))
        for t, a, b in idents:
            out += struct.pack("<iii", t, a, b)
        return bytes(out)

    def _have_log_entry(self, t: int, a: int, b: int) -> bool:
        """Does this rank provably already hold the advertised entry?
        Reads exactly the dedup state that would have dropped the old
        blast's duplicate — an entry this returns True for would have
        been a wasted re-flood frame (counted in reflood_skipped)."""
        if t == int(Tag.BCAST):
            if a == self.rank or b < 0:
                return True  # my own, or unstamped (not recoverable)
            ent = self._seen_bcast.get(a)
            return ent is not None and (b <= ent[0] or b in ent[1])
        if t in (int(Tag.IAR_DECISION), int(Tag.ABORT)):
            if t == int(Tag.IAR_DECISION) and a <= MEMBER_PID_BASE:
                # membership decisions are never WANTed: the welcome /
                # sync-response member records are the authoritative
                # channel, and a stale admission about a since-
                # re-failed rank must not resurrect it (the same rule
                # _replay_recent applies)
                return True
            return b < 0 or (a, b) in self._settled_set
        if t == int(Tag.FAILURE):
            # a = failed rank, b = declarer epoch: already adopted,
            # about myself (heal probes cover self-failure learning),
            # or stale against an admission executed since
            return (a == self.rank or a in self.failed or
                    b < self._admit_epoch.get(a, 0))
        return True

    def _discount_failed_voter(self, rank: int) -> None:
        """A consensus participant died mid-round: its subtree's merged
        vote will never arrive (sends to it blackhole). Discount it from
        every pending proposal — a dead rank cannot veto — and complete
        rounds that were only waiting on it."""
        p = self.my_own_proposal
        if (p.state == ReqState.IN_PROGRESS and rank in p.await_from
                and not p.decision_pending):
            p.await_from.remove(rank)
            p.votes_needed -= 1
            if p.votes_recved == p.votes_needed:
                self._complete_own_proposal(p)
        for pm in list(self.queue_iar_pending):
            ps = pm.prop_state
            if ps is not None and rank in ps.await_from:
                ps.await_from.remove(rank)
                ps.votes_needed -= 1
                if ps.votes_recved == ps.votes_needed:
                    self._resolve_relay(ps)

    def _abort_orphaned_proposals(self, rank: int) -> None:
        """Relayed proposals whose PROPOSER is the dead rank can never
        resolve (the decision will never be broadcast): mark them FAILED
        and unpark them, so the engine is checkpointable again and the
        pid is freed. This is the one place the rebuild assigns the
        reference's otherwise-dead RLO_FAILED state (rootless_ops.h:66).

        Rounds whose vote-tree PARENT died stay parked: the surviving
        proposer discounts the dead subtree and still broadcasts a
        decision, which reaches this rank through the re-formed overlay
        and clears the round (with the action callback) exactly like a
        healthy one. Keeping the round alive also preserves the child
        votes already merged into it, so a duplicate proposal from the
        new tree collects the true subtree verdict instead of a vote
        reconstructed from partial state (found in review)."""
        for pm in list(self.queue_iar_pending):
            ps = pm.prop_state
            if ps is None:
                continue
            if pm.frame.origin == rank:
                ps.state = ReqState.FAILED
                self.queue_iar_pending.remove(pm)

    # ------------------------------------------------------------------
    # Membership epochs + elastic rejoin (net-new, docs/DESIGN.md §8).
    #
    # The protocol in one paragraph: every rank carries a monotone
    # membership *epoch* (bumped on every failure adoption and every
    # admission) that the send gate stamps into every outgoing frame.
    # Receivers quarantine (a) everything from a sender they consider
    # failed, (b) frames below the per-sender epoch floor set at that
    # sender's last admission, and (c) everything while they are
    # themselves mid-rejoin — so a dead incarnation's stale traffic is
    # mechanically distinguishable from post-rejoin traffic. A failed-
    # but-alive rank (network partition, false positive, restart with
    # a fresh incarnation) converges back in by the JOIN protocol:
    # ranks probe their failed peers with Tag.JOIN carrying their view
    # key (epoch, -min-alive-rank, with rank id as the final tiebreak);
    # the losing view's ranks become *joiners* (quarantine everything,
    # petition at join_interval), and a winning-side member that
    # receives a petition runs the EXISTING IAR consensus over the
    # member set to admit the joiner — the rootless op voting on its
    # own membership. The admitting proposer then sends JOIN_WELCOME
    # (agreed epoch + member list) and replays its recent-broadcast
    # log point-to-point so the joiner converges; both sides reset the
    # joiner's ARQ link state, and the epoch floor quarantines any
    # stale in-flight frames that predate the admission.
    # ------------------------------------------------------------------
    def _member_pid(self, joiner: int) -> int:
        return MEMBER_PID_BASE - (joiner * self.world_size + self.rank)

    def _member_joiner(self, pid: int) -> Optional[int]:
        """joiner rank encoded in a membership pid, or None."""
        if pid > MEMBER_PID_BASE:
            return None
        return (MEMBER_PID_BASE - pid) // self.world_size

    @staticmethod
    def _member_decode(payload: bytes):
        """(new_epoch, [(joiner, incarnation), ...]) from a batched
        admission record (MEMBER_MAGIC + <ii>(new_epoch, k) +
        k x <ii>(joiner, inc)), or None."""
        if not payload.startswith(MEMBER_MAGIC) or \
                len(payload) < len(MEMBER_MAGIC) + 8:
            return None
        new_epoch, k = struct.unpack_from("<ii", payload,
                                          len(MEMBER_MAGIC))
        if k < 1 or len(payload) < len(MEMBER_MAGIC) + 8 + 8 * k:
            return None
        recs = [struct.unpack_from("<ii", payload,
                                   len(MEMBER_MAGIC) + 8 + 8 * i)
                for i in range(k)]
        return new_epoch, recs

    def _view_key(self):
        """Total order on membership views: higher epoch wins, then
        the side containing the lower rank (disjoint split-brain views
        always differ there); _on_join breaks exact ties by rank id."""
        base = min(self._alive) if self._alive else self.rank
        return (self.epoch, -base)

    def _become_joiner(self) -> None:
        """Enter joiner mode: quarantine everything except membership
        frames and petition for readmission until a JOIN_WELCOME
        arrives. The full-quarantine gate is what makes the admission's
        link-sequence reset safe — no stale ACK or old-seq frame can
        touch the fresh link state."""
        if self._awaiting_welcome:
            return
        # my own in-flight round can never resolve once I quarantine
        # everything (its votes would be dropped unread): fail it now
        # and free the slot instead of waiting out the op deadline
        p = self.my_own_proposal
        if p.state == ReqState.IN_PROGRESS and not p.decision_pending:
            self._abort_own_proposal(p)
        self._awaiting_welcome = True
        self._join_last_probe = float("-inf")

    def rejoin(self, incarnation: Optional[int] = None) -> int:
        """Explicitly petition for readmission with a fresh
        incarnation (docs/DESIGN.md §8): bumps ``incarnation`` (or
        adopts the given one), re-partitions the broadcast-seq and
        round-generation spaces so peers' dedup windows stay correct,
        and enters joiner mode — JOIN probes go out at
        ``join_interval`` until an admitting member's JOIN_WELCOME
        arrives (``rejoins`` increments on adoption). A restarted
        process can equivalently pass ``incarnation=`` at
        construction, which starts the engine in joiner mode. Returns
        the new incarnation."""
        inc = self.incarnation + 1 if incarnation is None \
            else int(incarnation)
        if inc < self.incarnation:
            raise ValueError(
                f"incarnation must not go backwards: {inc} < "
                f"{self.incarnation}")
        if inc > _incarnation_cap(self.world_size):
            raise ValueError(
                f"incarnation {inc} exceeds the cap "
                f"{_incarnation_cap(self.world_size)} for world_size "
                f"{self.world_size}: the shifted, rank-qualified gen "
                f"base must fit the int32 wire fields")
        self.incarnation = inc
        base = inc << INCARNATION_SHIFT
        if self._bcast_seq < base:
            self._bcast_seq = base
        if self._gen_next <= base:
            self._gen_next = base + 1
        # rlo-model: edge restart->joiner
        self._become_joiner()
        self._join_last_probe = float("-inf")
        self.manager.progress_all()
        return inc

    def _send_join_probe(self, dst: int) -> None:
        # (incarnation, epoch, min-alive-rank, petition, member):
        # petition=1 marks a JOINER's plea (it has reset itself and
        # quarantines everything) vs a survivor's heal probe at a
        # failed peer; member=1 tells dst it is ALIVE in the sender's
        # view — a losing-view receiver then catches up with a
        # Tag.MSYNC view sync instead of a full rejoin (§18). Old
        # 4-field probes parse as member=0 (full rejoin: status quo).
        payload = struct.pack(
            "<iiiii", self.incarnation, self.epoch,
            min(self._alive) if self._alive else self.rank,
            1 if self._awaiting_welcome else 0,
            0 if (self._awaiting_welcome or dst in self.failed) else 1)
        self._send_raw(dst, int(Tag.JOIN),
                       Frame(origin=self.rank, payload=payload).encode())
        TRACER.emit(self.rank, Ev.JOIN, dst, 1, self.incarnation,
                    self.epoch)

    def _membership_tick(self) -> None:
        """Joiner side: petition every potential member at
        join_interval. Survivor side: launch queued admission rounds
        once the (single) own-proposal slot frees up, and probe
        failed-but-maybe-alive peers so a healed partition or silent
        restart is discovered without any out-of-band signal."""
        now = self.clock()
        if self._awaiting_welcome:
            if now - self._join_last_probe >= self.join_interval:
                self._join_last_probe = now
                for dst in range(self.world_size):
                    if dst != self.rank and \
                            dst not in self._sub_excluded:
                        self._send_join_probe(dst)
            return
        # thundering-herd damper (docs/DESIGN.md §14): a joiner
        # petitions EVERY member, but only the DESIGNATED admitter —
        # the lowest-ranked member of my alive view (the same
        # deterministic rule the serving fabric uses for placement
        # proposals) — launches the IAR admission round. Without
        # this, n members each run an O(n)-frame consensus round per
        # probe interval: a quadratic admission storm that stalls
        # 10k-rank fleets (found by the churn bench). Petitions stay
        # queued on everyone else, so if the designated admitter dies
        # mid-admission the next view change re-designates and the
        # joiner's steady re-petitions keep liveness.
        # _alive is maintained sorted everywhere, so [0] IS the
        # minimum — min() would rescan n entries on every progress
        # turn of every petition-holding member
        if self._pending_joins and \
                self.my_own_proposal.state != ReqState.IN_PROGRESS \
                and self._alive[0] == self.rank:
            # batched admissions (docs/DESIGN.md §18): drain EVERY
            # servable queued petition into one IAR round — under
            # churn the petitions arrive in bursts (every victim of a
            # partition heals at once), and k sequential rounds were
            # the measured admission_rounds amplifier
            batch = []
            max_jep = self.epoch
            for joiner in list(self._pending_joins):
                inc, jep = self._pending_joins.pop(joiner)
                if joiner in self.failed and \
                        joiner not in self._admitting:
                    batch.append((joiner, inc))
                    if jep > max_jep:
                        max_jep = jep
            if batch:
                # the agreed post-admission epoch: above EVERY side's
                # view, so each joiner's fresh frames clear every
                # member's floor and their old lives' frames never do
                new_epoch = max_jep + 1
                payload = MEMBER_MAGIC + struct.pack(
                    "<ii", new_epoch, len(batch))
                for joiner, inc in batch:
                    self._admitting.add(joiner)
                    payload += struct.pack("<ii", joiner, inc)
                # membership watchdog (mirror of the C engine's
                # own_deadline): an engine-initiated round straddling
                # a view change can park into a cyclic mixed-view
                # vote tree; it must fail-and-retry even when the app
                # runs without op deadlines
                deadline = self.op_deadline
                if deadline is None:
                    deadline = max(
                        4 * (self.failure_timeout or 0.0),
                        20 * self.join_interval)
                self.admission_rounds += 1
                self.submit_proposal(payload,
                                     pid=self._member_pid(batch[0][0]),
                                     deadline=deadline)
        # cadence gate first: the set difference allocates, and this
        # runs every progress turn while any peer is failed
        if now - self._join_last_probe >= self.join_interval:
            probe = self.failed - self._sub_excluded
            if probe:
                self._join_last_probe = now
                for dst in sorted(probe):
                    self._send_join_probe(dst)

    def _on_join(self, msg: _Msg) -> None:
        """A JOIN probe/petition arrived: compare view keys. If the
        sender's view loses and it is failed here, petition to admit
        it (IAR over the member set). If its view wins, become a
        joiner ourselves (split-brain heal = mutual rejoin, higher
        epoch winning). If it probes us while we hold the winning view
        but consider it alive, answer with our own probe so it
        petitions us."""
        src = msg.src
        if not (0 <= src < self.world_size) or src == self.rank or \
                src in self._sub_excluded:
            return
        f = msg.frame
        if len(f.payload) < 16:
            return
        inc, ep, malive, petition = struct.unpack_from("<iiii",
                                                       f.payload)
        # 5th field (added with the digest heal): dst-is-a-member flag; absent on old
        # 4-field probes, which parse as 0 (full rejoin: status quo)
        member = struct.unpack_from("<i", f.payload, 16)[0] \
            if len(f.payload) >= 20 else 0
        TRACER.emit(self.rank, Ev.JOIN, src, 0, inc, ep)
        if self._awaiting_welcome:
            return  # mid-rejoin ourselves; the winning side sorts us
        my_key, their_key = self._view_key(), (ep, -malive)
        mine_wins = my_key > their_key or \
            (my_key == their_key and self.rank < src)
        if src in self.failed:
            if not mine_wins:
                if member:
                    # the winning view still holds me as a member: I
                    # am merely epoch-lagging, not excluded — catch up
                    # with a view-state sync instead of the full
                    # rejoin that used to strand every laggard (§18)
                    self._request_sync(src)
                    return
                # rlo-model: edge join->joiner
                self._become_joiner()
                return
            if inc < self._admitted.get(src, -1):
                return  # stale probe from an already-replaced life
            if src in self._admitting or src in self._pending_joins:
                return  # a round for it is already queued/in flight
            self._pending_joins[src] = (inc, ep)
        elif not mine_wins:
            if member:
                self._request_sync(src)
                return
            # rlo-model: edge join->joiner
            self._become_joiner()
        elif petition:
            admitted_inc = self._admitted.get(src, -1)
            if inc < admitted_inc:
                return  # stale petition from an already-replaced life
            if inc == admitted_inc and \
                    ep < self._reset_epoch.get(src, 0):
                # sync-supersedes-welcome (§18): this exact life was
                # already admitted here, so its JOIN_WELCOME was lost
                # in flight. The old answer — re-declare it failed and
                # re-admit — was the measured rejoin-cascade
                # amplifier; a view-state sync response carries
                # everything the welcome did and repeats for free on
                # the petition cadence until one lands. The epoch
                # guard tells the two ways a known life can petition
                # apart: a lost-welcome joiner still holds its
                # pre-admission epoch (the admission round chose
                # new_epoch strictly above every petitioner's), while
                # a life that SAW its welcome and later self-demoted
                # to joiner (asymmetric heal chaos) petitions at
                # ep >= its reset epoch — serving that one a sync
                # livelocks, because _msync_adopt rightly refuses any
                # response that does not certify a fresh admission
                # for a mid-rejoin life; it needs the re-admission
                # below.
                self._msync_serve(src)
                return
            # a rank we consider ALIVE is petitioning against our
            # winning view: it has reset itself and quarantines our
            # traffic, so it is effectively failed here — adopt +
            # announce that, then run the normal admission (without
            # this, a lone stale-view winner would answer petitions
            # with probes forever and nobody would ever admit anyone)
            self._announce_failed(src)
            if inc >= admitted_inc and src not in self._admitting:
                self._pending_joins[src] = (inc, ep)
        else:
            # the prober holds a losing view yet thinks we are alive
            # (asymmetric partition): show it the winning view
            self._send_join_probe(src)

    def _finish_member_round(self, p: ProposalState) -> None:
        """Admitting proposer's epilogue: execute the batch of
        admissions, then welcome + replay to each joiner."""
        adm = self._member_decode(self.my_proposal_payload)
        if adm is None:
            return
        new_epoch, recs = adm
        for joiner, _inc in recs:
            self._admitting.discard(joiner)
            self._pending_joins.pop(joiner, None)
        if not p.vote:
            return
        for joiner, inc in recs:
            if self._execute_admission(joiner, inc, new_epoch) and \
                    len(recs) > 1:
                self.batched_admits += 1
            self._send_welcome(joiner, inc, new_epoch)
            self._replay_recent(joiner)

    def _execute_admission(self, joiner: int, inc: int,
                           new_epoch: int) -> bool:
        """Adopt an admission decision into the membership view
        (idempotent): re-form the overlay to include the joiner, raise
        the epoch to the agreed value, set the joiner's epoch floor
        (its dead incarnation's frames all fall below it), and clear
        the RECEIVE-side ARQ window toward the joiner — a restarted
        joiner's link seqs start at 0, which the old window would
        misread as duplicates. The send-side seq counter is never
        reset (monotone for this process's lifetime), so a peer that
        keeps its window across our reset can never misread our fresh
        frames as duplicates either. Returns True when the admission
        actually executed (passed the idempotence guard)."""
        if not (0 <= joiner < self.world_size) or joiner == self.rank \
                or joiner in self._sub_excluded:
            return False
        if new_epoch <= self._admit_epoch.get(joiner, 0):
            # stale or duplicate admission artifact (an old decision
            # re-flooded out of a replaced view): executing it would
            # re-run the link reset ONE-SIDED and permanently desync
            # the ARQ windows on that edge
            return False
        self._admit_epoch[joiner] = new_epoch
        # a CERTIFIED link-reset epoch (unlike the wholesale welcome
        # inflation of _admit_epoch): sync responses built from it can
        # tell a laggard which floor is safe for this member (§18)
        self._reset_epoch[joiner] = new_epoch
        self.epoch = max(self.epoch, new_epoch)
        self._admitted[joiner] = max(inc, self._admitted.get(joiner, -1))
        self._epoch_floor[joiner] = new_epoch
        self._link_epoch[joiner] = new_epoch
        # clear the receive window even when we never marked the
        # joiner failed ourselves (another member re-declared and
        # re-admitted it; the joiner reset its half at the welcome, so
        # keeping ours would swallow its fresh seqs as duplicates).
        # Our tx seq counter is NOT reset — seq spaces are monotone
        # per process lifetime, so the joiner's window (fresh or kept)
        # never misreads our next frames; the unfillable-hole rule in
        # _on_ack re-syncs its cumulative-ACK watermark in one round
        # trip. App-level dedup ((origin, seq) windows + the
        # settled-round ring) keeps delivery exactly-once across the
        # reset.
        self._tx_unacked.pop(joiner, None)
        self._tx_skip.pop(joiner, None)
        self._rx_seen.pop(joiner, None)
        self._ack_due.discard(joiner)
        # joiner-liveness grace (§18): a mid-rejoin joiner does not
        # heartbeat until its JOIN_WELCOME (or superseding sync)
        # lands, so a plain now-stamp re-declares it failed whenever
        # the welcome leg outlasts failure_timeout — the self-
        # reinforcing half of the rejoin cascade. Date the stamp into
        # the future by half the admission-round deadline; any
        # accepted frame from the joiner refreshes it to a live stamp.
        self._hb_seen[joiner] = self.clock() + max(
            2 * (self.failure_timeout or 0.0), 10 * self.join_interval)
        # abandoned concurrent admission rounds for this joiner (their
        # proposer's watchdog fired, or the round wedged in a
        # mixed-view tree) are settled by THIS admission: unpark
        # their parked relays so they don't accumulate across heal
        # churn (mirror of the C execute_admission sweep)
        for pm in list(self.queue_iar_pending):
            if pm.prop_state is not None and \
                    pm.prop_state.pid <= MEMBER_PID_BASE and \
                    self._member_joiner(pm.prop_state.pid) == joiner:
                pm.prop_state.state = ReqState.FAILED
                self.queue_iar_pending.remove(pm)
        # a stale FAILURE notice about the joiner must never be
        # re-flooded: it would kill the fresh incarnation
        self._purge_stale_failures({joiner})
        if joiner not in self.failed:
            return True  # view unchanged (concurrent admitting proposer)
        self.failed.discard(joiner)
        self._alive, self._v = topology.shared_view(
            tuple(sorted(self._alive + [joiner])))
        self.group = self._alive
        self.rejoins += 1
        self.view_changes += 1
        TRACER.emit(self.rank, Ev.ADMIT, joiner, self.epoch, inc)
        logger.info("rank %d admitted rank %d (incarnation %d, epoch "
                    "%d); members now %s", self.rank, joiner, inc,
                    self.epoch, self._alive)
        # plug forwarding holes across the overlay re-form, exactly
        # like the failure path does
        self._reflood_recent_bcasts()
        return True

    def _send_welcome(self, joiner: int, inc: int,
                      new_epoch: int) -> None:
        members = list(self._alive)
        payload = struct.pack("<iii", new_epoch, inc, len(members)) + \
            struct.pack(f"<{len(members)}i", *members)
        self._send_raw(joiner, int(Tag.JOIN_WELCOME),
                       Frame(origin=self.rank, payload=payload).encode())

    def _replay_recent(self, joiner: int) -> None:
        """Point-to-point replay of the recent-broadcast log to a
        freshly admitted joiner so it converges on recent traffic
        (its (origin, seq) dedup absorbs anything it already saw).
        FAILURE notices AND membership decisions are skipped — the
        welcome's member list is the authoritative view, and a stale
        admission decision about a since-re-failed rank would pass the
        joiner's _admit_epoch guard (reset by the welcome) and
        resurrect the dead rank in its view. The guarantee is bounded
        by the admitting proposer's log depth (the same 64-frame bound
        as the view-change re-flood, docs/DESIGN.md §6)."""
        for tag, raw in list(self._recent_bcasts):
            if tag == int(Tag.FAILURE):
                continue
            if tag == int(Tag.IAR_DECISION) and \
                    Frame.decode(raw).pid <= MEMBER_PID_BASE:
                continue
            self._send_raw(joiner, tag, raw)

    def _purge_stale_failures(self, ranks: Set[int]) -> None:
        keep = deque(maxlen=self._recent_bcasts.maxlen)
        for tag, raw in self._recent_bcasts:
            if tag == int(Tag.FAILURE) and \
                    Frame.decode(raw).pid in ranks:
                continue
            keep.append((tag, raw))
        self._recent_bcasts = keep

    def _on_welcome(self, msg: _Msg) -> None:
        """The admitting proposer's JOIN_WELCOME: adopt its membership
        view wholesale — epoch, member list, fresh link state and
        heartbeat grace everywhere, per-member epoch floors at the
        agreed epoch (members only send to us AFTER executing the
        admission, so everything below the floor is pre-partition
        leftovers). The replay of the proposer's recent-broadcast log
        follows on the same FIFO channel."""
        f = msg.frame
        if len(f.payload) < 12:
            return
        new_epoch, inc, n = struct.unpack_from("<iii", f.payload)
        if inc != self.incarnation:
            return  # welcome addressed to an older life of this rank
        if n < 0 or len(f.payload) < 12 + 4 * n:
            return
        members = list(struct.unpack_from(f"<{n}i", f.payload, 12)) \
            if n else []
        if not self._awaiting_welcome and \
                new_epoch <= self._welcome_epoch:
            # duplicate/stale welcome (concurrent admitting proposers).
            # Deliberately compared against the last ADOPTED welcome
            # epoch, not self.epoch: our own epoch can outrun the
            # round's agreed epoch via local declarations, and
            # rejecting the welcome then would leave the admitting
            # side's link-state reset one-sided (a permanently
            # desynced ARQ window) — the exact mirror of the members'
            # _admit_epoch idempotence rule.
            return
        # rlo-model: edge welcome->member
        self._adopt_view(new_epoch, members, inc, msg.src)

    def _adopt_view(self, new_epoch: int, members, inc: int,
                    src: int) -> None:
        """Wholesale view adoption — the shared core of JOIN_WELCOME
        and the sync-supersede path (§18): a certified admission of
        THIS life at ``new_epoch`` whose notification reached us
        either as the welcome itself or as a sync response after the
        welcome was lost. Adopts epoch, member list, fresh link state
        and heartbeat grace everywhere, per-member epoch floors at the
        agreed epoch (members only send to us AFTER executing the
        admission, so everything below the floor is pre-partition
        leftovers)."""
        # out-of-range entries (corrupt/foreign frame) are dropped,
        # not adopted — the C on_welcome filters identically
        mem = sorted({m for m in members
                      if 0 <= m < self.world_size} | {self.rank})
        self._awaiting_welcome = False
        self.suspected_self = False
        self._welcome_epoch = max(self._welcome_epoch, new_epoch)
        self.epoch = max(self.epoch, new_epoch)
        for m in mem:
            if m != self.rank:
                # members of the adopted view are known-alive at this
                # epoch: FAILURE notices declared below it are stale
                self._admit_epoch[m] = max(
                    self._admit_epoch.get(m, 0), new_epoch)
        self._alive, self._v = topology.shared_view(tuple(mem))
        self.failed = (set(range(self.world_size)) - set(mem)) | \
            set(self._sub_excluded)
        self.group = self._alive
        # clear receive windows and in-flight state; the tx seq
        # counters are PRESERVED (monotone per process lifetime) so a
        # member whose matching admission execution was suppressed as
        # stale — its rx watermark intact — still reads our next
        # frames as fresh instead of silently dup-dropping them (the
        # half-dead-link deadlock: every IAR round crossing that edge
        # would hang, invisible to the heartbeat detector because
        # liveness refreshes before the dup check)
        self._tx_unacked.clear()
        self._tx_skip.clear()
        self._rx_seen.clear()
        self._ack_due.clear()
        self._hb_seen = {}
        self._hb_last_sent = float("-inf")
        self._epoch_floor = {m: new_epoch for m in mem
                             if m != self.rank}
        self._link_epoch = {m: new_epoch for m in mem
                            if m != self.rank}
        # our pre-adoption link-reset certifications described a view
        # we just replaced wholesale; serving sync floors from them
        # would hand laggards one-sided floors (§18)
        self._reset_epoch.clear()
        self._sync_req_last.clear()
        self._purge_stale_failures(set(mem))
        # relayed rounds whose proposer is outside the adopted view
        # can never resolve here — unpark them as FAILED (the mirror
        # of _abort_orphaned_proposals for the joiner side)
        for pm in list(self.queue_iar_pending):
            if pm.frame.origin not in mem and pm.prop_state is not None:
                pm.prop_state.state = ReqState.FAILED
                self.queue_iar_pending.remove(pm)
        self.rejoins += 1
        self.view_changes += 1
        self._join_last_probe = float("-inf")
        # advertise the log retained across the rejoin: this rank may
        # be the SOLE holder of its old life's entries (e.g. an abort
        # flooded while partitioned alone), and no later view change
        # is guaranteed to occur here — the WANT-side guards
        # (_have_log_entry) make stale entries harmless
        self._reflood_recent_bcasts()
        TRACER.emit(self.rank, Ev.ADMIT, self.rank, self.epoch, inc,
                    src)
        logger.info("rank %d rejoined at epoch %d (welcomed by rank "
                    "%d); members %s", self.rank, self.epoch, src,
                    mem)

    # -- Tag.MSYNC: view-state sync (docs/DESIGN.md §18) ---------------

    def _request_sync(self, dst: int) -> None:
        """Ask an up-to-date peer for a view-state sync: the epoch
        catch-up path that replaces the full rejoin a laggard used to
        be stranded into. Rate-limited per destination at
        join_interval — the probes that trigger it repeat on the
        peer's heal-probe cadence, so one outstanding REQ per peer is
        enough and loss costs one cadence interval, never progress."""
        now = self.clock()
        if now - self._sync_req_last.get(dst, float("-inf")) < \
                self.join_interval:
            return
        self._sync_req_last[dst] = now
        payload = struct.pack("<Bii", MSYNC_REQ, self.epoch,
                              self.incarnation)
        self._send_raw(dst, int(Tag.MSYNC),
                       Frame(origin=self.rank, payload=payload).encode())

    def _on_msync(self, msg: _Msg) -> None:
        """Dispatch a Tag.MSYNC frame by kind byte. MSYNC is ARQ- and
        epoch-exempt exactly like JOIN — REQs repeat on the probe
        cadence, adverts are re-issued on every view change — so a
        lost frame costs latency, never correctness."""
        src = msg.src
        if not (0 <= src < self.world_size) or src == self.rank or \
                src in self._sub_excluded:
            return
        p = msg.frame.payload
        if len(p) < 1:
            return
        kind = p[0]
        if kind == MSYNC_REQ:
            if len(p) < 9:
                return
            _req_ep, inc = struct.unpack_from("<ii", p, 1)
            if src in self.failed:
                # can't certify link state toward a rank this view
                # holds failed: show it the winning view so it
                # petitions for readmission instead
                self._send_join_probe(src)
                return
            if inc < self._admitted.get(src, -1):
                return  # stale REQ from an already-replaced life
            self._msync_serve(src)
        elif kind == MSYNC_RSP:
            self._msync_adopt(msg, p)
        elif kind == MSYNC_AD:
            # a joiner's dedup state is mid-reset and a failed peer's
            # link is quarantined: neither side can exchange WANTs
            if not self._awaiting_welcome and src not in self.failed:
                self._msync_advert(src, p, 1)
        elif kind == MSYNC_WANT:
            if not self._awaiting_welcome and src not in self.failed:
                self._msync_want(src, p)

    def _msync_serve(self, dst: int) -> None:
        """Build + send a MSYNC_RSP: epoch, member records, and the
        recent-log advert. Per-member records carry only CERTIFIED
        link-reset epochs (_reset_epoch, set solely by
        _execute_admission) — never the wholesale welcome inflation of
        _admit_epoch, which would hand the laggard a one-sided floor
        for members whose links were never actually reset (§18)."""
        if self._awaiting_welcome:
            return  # mid-rejoin: nothing certifiable to serve
        payload = bytearray(struct.pack(
            "<Bii", MSYNC_RSP, self.epoch, len(self._alive)))
        for m in self._alive:
            if m == self.rank:
                payload += struct.pack("<iii", m, self._welcome_epoch,
                                       self.incarnation)
            else:
                payload += struct.pack(
                    "<iii", m, self._reset_epoch.get(m, 0),
                    self._admitted.get(m, -1))
        ad = self._advert_payload()
        # embedded advert tail: same <i>count + <iii>-triple body as a
        # standalone MSYNC_AD, minus its kind byte
        payload += ad[1:] if ad is not None else struct.pack("<i", 0)
        if len(payload) + 64 > MSG_SIZE_MAX:
            # view too large for one frame (pathological world_size):
            # fall back to the full-rejoin path rather than truncate
            self._send_join_probe(dst)
            return
        self._send_raw(dst, int(Tag.MSYNC),
                       Frame(origin=self.rank,
                             payload=bytes(payload)).encode())

    def _msync_adopt(self, msg: _Msg, p: bytes) -> None:
        """A MSYNC_RSP arrived: catch up to the responder's view
        without a full rejoin. Three cases: (1) the response certifies
        an admission of THIS life we never saw the welcome for —
        wholesale adoption, exactly as the welcome would have done
        (sync-supersedes-welcome); (2) we are a mere epoch laggard —
        execute the certified per-member admissions we missed and
        adopt the responder's failures; (3) nothing certifiable heals
        the link to the responder — fall back to a full rejoin, the
        pre-§18 status quo, so every sync exchange strictly
        progresses."""
        src = msg.src
        if len(p) < 9:
            return
        rsp_epoch, n = struct.unpack_from("<ii", p, 1)
        if n < 0 or len(p) < 9 + 12 * n:
            return
        # staleness, judged at ARRIVAL epoch (adoption below may raise
        # it): a response no newer than my view means I progressed
        # past the request in flight — I am not the laggard anymore
        stale = rsp_epoch <= self.epoch
        recs = [struct.unpack_from("<iii", p, 9 + 12 * i)
                for i in range(n)]
        ad_off = 9 + 12 * n
        mine = next(((aep, ainc) for m, aep, ainc in recs
                     if m == self.rank), None)
        if mine is None:
            # the responder's view does not hold me at all: if it
            # wins, only a full rejoin gets me back in
            if rsp_epoch > self.epoch:
                # rlo-model: edge msync->joiner
                self._become_joiner()
            return
        aep, ainc = mine
        adopted = False
        if ainc == self.incarnation and aep > self._welcome_epoch:
            # lost-welcome supersede: the responder certifies THIS
            # life was admitted at aep but no welcome ever landed —
            # adopt the view wholesale with the welcome's exact
            # semantics (un-wedges _awaiting_welcome, satellite a)
            # rlo-model: edge msync->member
            self._adopt_view(aep, [m for m, _a, _i in recs],
                             self.incarnation, src)
            self.epoch = max(self.epoch, rsp_epoch)
            adopted = True
        elif self._awaiting_welcome:
            # mid-rejoin and the response does not certify this life:
            # keep petitioning — only an admission can help now
            return
        else:
            # laggard catch-up: execute certified admissions (aep > 0
            # entries only; a zero means "no reset I can vouch for")
            for m, maep, mainc in recs:
                if m != self.rank and maep > 0 and \
                        maep > self._admit_epoch.get(m, 0):
                    if self._execute_admission(m, mainc, maep):
                        adopted = True
            if rsp_epoch > self.epoch:
                # adopt the responder's failures: ranks alive here but
                # absent from its strictly-newer view, unless an
                # admission we already executed post-dates it
                present = {m for m, _a, _i in recs}
                for r in [r for r in self._alive if r != self.rank
                          and r not in present]:
                    if rsp_epoch > self._admit_epoch.get(r, 0):
                        self._mark_failed(r)
                self.epoch = max(self.epoch, rsp_epoch)
                adopted = True
        if src in self.failed:
            if stale:
                # the RSP predates local progress: dropping it is
                # safe — my frames at the responder trigger ITS sync
                # or rejoin, and becoming a joiner off stale state
                # can wedge the whole fleet in joiner mode (the
                # last member self-demoting leaves no admitter)
                return
            # progress fallback: nothing in the response re-certified
            # the responder's link, so the two views cannot converge
            # by sync alone — full rejoin (status quo ante)
            # rlo-model: edge msync->joiner
            self._become_joiner()
            return
        if adopted:
            self.epoch_syncs += 1
        if len(p) >= ad_off + 4:
            self._msync_advert(src, p, ad_off)

    def _msync_advert(self, src: int, p: bytes, off: int) -> None:
        """MSYNC_AD body at ``off``: <i>count + count x <iii>(tag, a,
        b) recent-log identities. Answer with a WANT naming exactly
        the entries this rank provably misses; each entry already held
        is a re-flood frame the old blast would have wasted
        (reflood_skipped)."""
        if len(p) < off + 4:
            return
        cnt = struct.unpack_from("<i", p, off)[0]
        if cnt < 0 or len(p) < off + 4 + 12 * cnt:
            return
        want = []
        for i in range(cnt):
            t, a, b = struct.unpack_from("<iii", p, off + 4 + 12 * i)
            if self._have_log_entry(t, a, b):
                self.reflood_skipped += 1
            else:
                want.append((t, a, b))
        if not want:
            return
        out = bytearray(struct.pack("<Bi", MSYNC_WANT, len(want)))
        for t, a, b in want:
            out += struct.pack("<iii", t, a, b)
        self._send_raw(src, int(Tag.MSYNC),
                       Frame(origin=self.rank,
                             payload=bytes(out)).encode())

    def _msync_want(self, src: int, p: bytes) -> None:
        """A WANT reply to our advert: re-send exactly the named
        recent-log entries (through the ARQ gate, fresh link seqs —
        a new transmission, not a retransmit; app-level dedup absorbs
        any crossing duplicates)."""
        if len(p) < 5:
            return
        cnt = struct.unpack_from("<i", p, 1)[0]
        if cnt < 0 or len(p) < 5 + 12 * cnt:
            return
        wanted = {struct.unpack_from("<iii", p, 5 + 12 * i)
                  for i in range(cnt)}
        for tag, raw in list(self._recent_bcasts):
            if self._log_entry_ident(tag, raw) in wanted:
                self.reflood_frames += 1
                self._send_raw(src, tag, raw)

    def _on_other(self, msg: _Msg) -> None:
        """Unknown/aux tags go straight to pickup (reference prints and
        drops, :617-620; delivering is strictly more useful)."""
        msg.fwd_done = True
        self.queue_pickup.append(msg)

    def _find_proposal_msg(self, pid: int, gen: int) -> Optional[_Msg]:
        """~_find_proposal_msg (:1036-1053), extended to match on
        (pid, generation) so rounds reusing a pid never shadow each
        other in the pending queue."""
        for m in self.queue_iar_pending:
            if m.prop_state is not None and m.prop_state.pid == pid \
                    and m.prop_state.gen == gen:
                return m
        return None

    # ------------------------------------------------------------------
    # Teardown (~RLO_progress_engine_cleanup, rootless_ops.c:1606-1647)
    # ------------------------------------------------------------------
    def idle(self) -> bool:
        """No pending forwards or undelivered internal work on this
        engine. With ARQ enabled, unacked reliable frames count as
        outstanding work: an idle engine's sends are not just handed to
        the transport but acknowledged delivered (or given up on)."""
        return (not self.queue_wait and not self.queue_wait_and_pickup
                and not self.my_own_proposal.decision_pending
                and (self.arq_rto is None or self.arq_unacked() == 0))

    def cleanup(self) -> None:
        self.manager.remove(self)


def drain(worlds, engines, max_spins: int = 100_000) -> None:
    """Progress until every transport world is quiescent and every engine's
    outbound work is complete — the loopback analogue of the reference's
    termination-detection drain (MPI_Iallreduce over bcast counts + spin,
    rootless_ops.c:1613-1625)."""
    managers = []
    for e in engines:
        if e.manager not in managers:
            managers.append(e.manager)
    for _ in range(max_spins):
        # drive through the managers so the re-entrancy guard covers
        # handler-initiated broadcasts (e.g. the decision bcast)
        for m in managers:
            m.progress_all()
        if all(w.quiescent() for w in worlds) and all(
                e.idle() for e in engines):
            return
    raise RuntimeError("drain did not reach quiescence")
