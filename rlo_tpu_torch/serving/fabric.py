"""Rootless elastic serving fabric (docs/DESIGN.md §11).

The port's own copy of ``rlo_tpu/serving/fabric.py``, line for line:
only the imports and the logger names differ, so both packages give the
same results and the same bytes for the same seed
(``tests/test_torch_fabric.py`` holds them equal).

N ranks each run a ``DecodeFabric`` over one ``ProgressEngine`` and a
decode backend, and coordinate ENTIRELY through the paper's own
primitives — no scheduler rank, no root, no global synchronization:

  - **admission**: whichever rank a client reaches (the *gateway*)
    assigns a globally-unique request id ``(gateway, seq)`` and
    rootlessly broadcasts an ADMIT record; every member learns every
    accepted request, so any survivor can take over any of them.
  - **placement/routing**: slot-ownership records are decided by IAR
    consensus (``placement.Placement``) — the paper's protocol doing
    production scheduling. Admit-time owners come from the gateway's
    gossiped load view (Tag.SERVE reports); fail-over owners from
    rendezvous hashing over the agreed members.
  - **fail-over**: a killed or partitioned owner is detected by the
    engine's failure machinery (heartbeats, ARQ give-up, epochs); the
    survivors agree on a new placement and the deterministic
    re-placement rule re-queues the orphaned requests, each on exactly
    one survivor.
  - **exactly-once completion**: DONE records (the decoded tokens)
    broadcast to every member and dedup by request id — the first
    completion wins everywhere, re-decodes after ownership races are
    counted (``fabric.dup_decodes``), never delivered twice. Re-admission
    after a heal or rejoin re-broadcasts pending ADMITs and recent
    DONEs; the rid-level dedup absorbs every copy (the broadcast
    layer's own (origin, seq) dedup absorbs transport-level copies
    below it).

The fabric is clock-injectable (it takes the engine's clock) and free
of wall-clock and module randomness, so whole fleets replay
bit-for-bit inside the deterministic simulator — rlo-lint R5 enforces
this for ``serving/`` exactly as it does for the engine.
"""

from __future__ import annotations

import enum
import struct
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from rlo_tpu_torch.engine import (INCARNATION_SHIFT, ProgressEngine, ReqState,
                                  UserMsg)
from rlo_tpu_torch.observe.remedy import (REMEDY_KINDS, REMEDY_PID_BASE,
                                          RemedyRecord)
from rlo_tpu_torch.observe.spans import SpanRecorder, Stage
from rlo_tpu_torch.serving.placement import (Placement, healthy_members,
                                             owner_of, pick_owner)
from rlo_tpu_torch.utils.metrics import Registry, hist_summary
from rlo_tpu_torch.wire import (SPAN_F_SAMPLED, Tag, encode_span_ctx,
                                split_span_ctx)

#: Prefix marking a payload as a serving-fabric record (the serving
#: analogue of the engine's MEMBER_MAGIC): ADMIT/DONE ride Tag.BCAST,
#: LOAD rides Tag.SERVE, PLACE rides IAR proposal/decision payloads.
FABRIC_MAGIC = b"RLOF\x01"

#: Placement rounds use pid = FABRIC_PID_BASE + proposer rank: unique
#: per concurrent proposer (IAR forbids concurrent same-pid rounds),
#: reused across sequential rounds (the generation disambiguates), and
#: far above any test/app pid space.
FABRIC_PID_BASE = 1 << 20

#: request id: (gateway rank, gateway-local seq). Seqs are partitioned
#: by the gateway engine's incarnation (base = incarnation << 20,
#: mirroring the engine's own seq spaces) so a restarted gateway can
#: never reissue a dead life's rid.
Rid = Tuple[int, int]


class Rec(enum.IntEnum):
    """Fabric record kinds, dispatched in ``DecodeFabric._on_record``.
    rlo-lint R4 requires every member to be explicitly dispatched
    there (or annotated ``rlo-lint: default-route``) — the fabric twin
    of the engine's Tag-dispatch exhaustiveness rule. The remediation
    kinds (5..8) pin the same values as ``observe.remedy`` — that
    module owns the vocabulary but must not import the fabric."""
    ADMIT = 1   # gateway accepted a request: rid, owner, budget, prompt
    DONE = 2    # owner finished a request: rid, decoder, tokens
    PLACE = 3   # slot-ownership record (IAR payload; also re-floodable)
    LOAD = 4    # Tag.SERVE gossip: (free_slots, queue_depth)
    QUARANTINE = 5    # stop routing work to a rank (IAR-decided)
    UNQUARANTINE = 6  # lift a quarantine (IAR-decided)
    BACKPRESSURE = 7  # fleet AIMD admission throttle level (IAR-decided)
    REBALANCE = 8     # force a fresh placement round (IAR-decided)


class _FabReq:
    """One admitted request as every member tracks it. ``t_enq`` is
    the start of the CURRENT queue residency (reset when a failover
    re-queues the request), ``t_active`` the decode round that first
    ran it here (None while queued), ``traced`` whether the sampled
    bit rode in on the ADMIT record's span context."""
    __slots__ = ("prompt", "max_new", "eos_id", "gateway", "owner",
                 "t_admit", "t_enq", "t_active", "traced")

    def __init__(self, prompt: Tuple[int, ...], max_new: int,
                 eos_id: int, gateway: int, owner: int,
                 t_admit: float):
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.gateway = gateway
        self.owner = owner
        self.t_admit = t_admit
        self.t_enq = t_admit
        self.t_active: Optional[float] = None
        self.traced = False


def _enc_admit(rid: Rid, owner: int, max_new: int, eos_id: int,
               prompt: Sequence[int], ctx: bytes = b"") -> bytes:
    """``ctx`` is the optional span-context trailer (docs/DESIGN.md
    §19) — ``b""`` (tracing off) keeps the record byte-identical to
    the pre-span wire format."""
    p = tuple(int(t) for t in prompt)
    return (FABRIC_MAGIC + bytes([Rec.ADMIT]) +
            struct.pack(f"<iiiii{len(p)}i", rid[0], rid[1], owner,
                        max_new, eos_id, *p) + ctx)


def _enc_done(rid: Rid, decoder: int, tokens: Sequence[int],
              ctx: bytes = b"") -> bytes:
    t = tuple(int(x) for x in tokens)
    return (FABRIC_MAGIC + bytes([Rec.DONE]) +
            struct.pack(f"<iii{len(t)}i", rid[0], rid[1], decoder,
                        *t) + ctx)


def _enc_place(place: Placement, ctx: bytes = b"") -> bytes:
    return FABRIC_MAGIC + bytes([Rec.PLACE]) + place.encode() + ctx


def _enc_load(free: int, depth: int) -> bytes:
    return (FABRIC_MAGIC + bytes([Rec.LOAD]) +
            struct.pack("<ii", free, depth))


def _enc_remedy(rec: RemedyRecord) -> bytes:
    return FABRIC_MAGIC + bytes([rec.kind]) + rec.encode()


class DecodeFabric:
    """One rank's serving-fabric node: an engine endpoint plus a
    decode backend, driven by ``pump()`` from the harness/server loop
    (the same cooperative-polling inversion as the engine itself).

    ``decode_interval`` paces backend rounds on the ENGINE's clock
    (virtual time in the simulator), ``load_interval`` paces the
    Tag.SERVE load gossip, ``place_retry`` paces placement-round
    retries while the agreed record trails the membership view.

    ``done_ttl`` bounds the rid→tokens completion cache (the §12
    known-bounds rider): completions older than the horizon (engine
    clock seconds) are evicted during ``pump()`` and counted in
    ``fabric.done_evicted``, so a long-lived fabric's DONE table stops
    growing with lifetime traffic. Eviction drops the TOKEN PAYLOADS,
    not the exactly-once property: evicted rids leave tombstones in a
    bounded ring (``_EVICTED_RING``, two ints per entry), so a DONE or
    ADMIT replayed by a heal re-broadcast is absorbed, never
    re-completed or re-decoded. The practical contract for clients:
    ``result()`` returns None once a completion ages out, so read
    results within the horizon; size the TTL past the longest
    heal/replay window so tombstones are still ringed when replays
    arrive. ``None`` (the default) keeps the historical
    keep-everything behavior.
    """

    #: tombstone-ring depth for evicted completions (see done_ttl)
    _EVICTED_RING = 1 << 16

    def __init__(self, engine: ProgressEngine, backend, *,
                 decode_interval: float = 0.25,
                 load_interval: float = 1.0,
                 place_retry: float = 2.0,
                 done_ttl: Optional[float] = None,
                 metrics: Optional[Registry] = None,
                 spans: Optional[SpanRecorder] = None,
                 bp_base: float = 0.5,
                 bp_window: float = 25.0,
                 remedy_min_alive: Optional[int] = None,
                 remedy_blast_frac: float = 0.25,
                 avoid_lag: int = 4,
                 avoid_stale: float = 10.0):
        self.engine = engine
        self.backend = backend
        self.rank = engine.rank
        self.clock = engine.clock
        self.decode_interval = decode_interval
        self.load_interval = load_interval
        self.place_retry = place_retry
        self.done_ttl = done_ttl
        self.metrics = Registry() if metrics is None else metrics
        #: attached span recorder (docs/DESIGN.md §19) — None (the
        #: default) is the zero-cost disabled path: no trailers are
        #: stamped and every instrumentation site is one `is None`
        #: branch
        self.spans = spans
        self._proposed_ctx: Optional[Tuple[int, int, int, int, int]] \
            = None
        if spans is not None and hasattr(backend, "attach_spans"):
            backend.attach_spans(spans)  # ModelBackend: prefill spans

        #: PENDING requests only — entries are evicted at completion
        #: (the prompt is dead weight once decoded), so every per-pump
        #: scan (_reconcile, the gauge) is O(in-flight work), not
        #: O(requests ever served)
        self.requests: Dict[Rid, _FabReq] = {}
        #: rid -> completed tokens; retained for result() reads and
        #: rid-level dedup (bounding this is a client-protocol
        #: question — see the §11 known-bounds note)
        self.done: Dict[Rid, Tuple[int, ...]] = {}
        self.done_by: Dict[Rid, int] = {}
        #: client-visible exactly-once completion log (rid, in the
        #: order completions were accepted here)
        self.completions: List[Rid] = []
        self.requeues = 0
        self.dup_done = 0
        self._local: set = set()    # rids submitted to my backend
        #: completion order with timestamps, for TTL eviction (clock
        #: values are monotone, so the left end is always the oldest)
        self._done_order: deque = deque()
        #: tombstones for evicted rids: the token payloads are gone but
        #: the rid-level exactly-once dedup must survive eviction — a
        #: DONE replayed by a heal re-broadcast (or a re-admission)
        #: for an aged-out rid must not re-complete it. BOUNDED: the
        #: ring caps tombstone memory (two ints per entry); replays
        #: only originate from peers' 64-deep ``_recent_done`` rings
        #: and pending-ADMIT re-broadcasts, so a ring orders of
        #: magnitude deeper than any fleet's replay sources keeps the
        #: dedup airtight while the table stays O(1) in lifetime
        #: traffic.
        self._evicted: set = set()
        self._evicted_ring: deque = deque(maxlen=self._EVICTED_RING)
        self._next_seq = engine.incarnation << INCARNATION_SHIFT
        self._loads: Dict[int, Tuple[int, int]] = {}
        self._recent_done: deque = deque(maxlen=64)
        self._last_view = tuple(sorted(engine.group))
        self._next_decode = float("-inf")
        self._next_load = float("-inf")
        self._next_place = float("-inf")
        self._my_place_pid = FABRIC_PID_BASE + self.rank
        self._proposed: Optional[Placement] = None

        # --- remediation state (docs/DESIGN.md §22) ---------------
        # the remedy pid window sits 1<<10 above the placement window;
        # a fleet wider than that would alias the two
        assert engine.world_size <= REMEDY_PID_BASE - FABRIC_PID_BASE
        self._my_remedy_pid = REMEDY_PID_BASE + self.rank
        self._proposed_remedy: Optional[RemedyRecord] = None
        #: the fleet-AGREED quarantine set (IAR-decided records only —
        #: identical at every member modulo propagation)
        self.quarantined: set = set()
        self._quar_ver: Dict[int, Tuple[int, int]] = {}
        #: latest record per target (either quarantine kind), for the
        #: view-growth re-broadcast — a restarted victim must learn
        #: its OWN quarantine from the survivors
        self._quar_recs: Dict[int, RemedyRecord] = {}
        #: AIMD admission backpressure: level L throttles local admits
        #: to one per ``bp_base * 2**(L-1)`` engine-clock seconds
        #: (multiplicative decrease); one level decays per clean
        #: ``bp_window`` (additive recovery)
        self.bp_level = 0
        self.bp_base = bp_base
        self.bp_window = bp_window
        self._bp_ver: Optional[Tuple[int, int]] = None
        self._bp_rec: Optional[RemedyRecord] = None
        self._bp_next_decay = float("inf")
        self._next_admit = float("-inf")
        self._admit_queue: deque = deque()
        self._rebal_ver: Optional[Tuple[int, int]] = None
        self._rebal_pending = False
        self._remedy_ver_max = 0
        #: judge invariants: never quarantine below this many live
        #: non-quarantined members (default = majority of the STATIC
        #: world — a partitioned minority can never satisfy it), never
        #: quarantine more than this fraction of the current group
        self.remedy_min_alive = (max(2, engine.world_size // 2 + 1)
                                 if remedy_min_alive is None
                                 else remedy_min_alive)
        self.remedy_blast_frac = remedy_blast_frac
        #: advisory fail-over filter thresholds (FleetView epoch lag /
        #: digest staleness — see placement.owner_of)
        self.avoid_lag = avoid_lag
        self.avoid_stale = avoid_stale
        #: execution audit: (vtime, kind name, target/level,
        #: group size, quarantine size after) — what the scenario
        #: property checks read
        self.remedy_log: List[Tuple] = []
        #: attached RemedyPolicy (observe/remedy.py), stepped by pump
        self.remedy = None
        #: attached telemetry plane (rlo_tpu_torch/observe/, docs/DESIGN.md
        #: §17): pump() feeds it Tag.TELEM pickups and ticks it
        self.telemetry = None
        #: the agreed slot-ownership record; construction-time members
        #: (identical everywhere) seed it, IAR rounds replace it
        self.placement = Placement(
            version=0, proposer=-1,
            members=tuple(sorted(engine.group)))
        # take over the engine's app surface; chain non-fabric
        # payloads to whatever was wired before
        self._prev_app = engine.set_app(judge_cb=self._judge,
                                        action_cb=self._action)

    # ------------------------------------------------------------------
    # client face
    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new: int,
               eos_id: Optional[int] = None) -> Rid:
        """Accept a request at this gateway: assign the rid, pick the
        admit-time owner from the load view (healthy members only —
        a quarantined rank is never handed new work), apply locally,
        and rootlessly broadcast the ADMIT record to the fleet.

        Under admission backpressure (``bp_level`` > 0, an IAR-decided
        BACKPRESSURE record) the rid is assigned immediately but the
        admit is queued and drained by ``pump()`` at the throttled
        rate — ``result(rid)`` simply stays None a little longer."""
        rid: Rid = (self.rank, self._next_seq)
        self._next_seq += 1
        eos = -1 if eos_id is None else int(eos_id)
        if self.bp_level > 0 or self._admit_queue:
            self._admit_queue.append(
                (rid, int(max_new), eos,
                 tuple(int(t) for t in prompt)))
            self.metrics.counter("fabric.admits_throttled").inc()
            return rid
        self._submit_now(rid, int(max_new), eos,
                         tuple(int(t) for t in prompt))
        return rid

    def _submit_now(self, rid: Rid, max_new: int, eos: int,
                    prompt: Tuple[int, ...]) -> None:
        owner = pick_owner(
            self.rank,
            healthy_members(self.placement.members, self.quarantined),
            self._loads)
        ctx = b""
        tup = None
        if self.spans is not None:
            sampled = self.spans.sampled(rid)
            t0 = int(round(self.clock() * 1e6))
            tup = (SPAN_F_SAMPLED if sampled else 0,
                   int(Stage.ADMIT_BCAST), rid[0],
                   rid[1] & 0x7FFFFFFF, t0)
            ctx = encode_span_ctx(rid[0], rid[1], Stage.ADMIT_BCAST,
                                  t0, tup[0])
        self._apply_admit(rid, owner, max_new, eos, prompt, tup)
        self.engine.bcast(_enc_admit(rid, owner, max_new, eos,
                                     prompt, ctx))

    def result(self, rid: Rid) -> Optional[Tuple[int, ...]]:
        """Completed tokens for ``rid``, or None while pending (or
        after the completion aged out of the ``done_ttl`` cache —
        clients must read results within the horizon)."""
        return self.done.get(rid)

    def pending(self) -> List[Rid]:
        return list(self.requests)

    # ------------------------------------------------------------------
    # IAR face: placement rounds (docs/DESIGN.md §11)
    # ------------------------------------------------------------------
    def _judge(self, payload: bytes, ctx) -> int:
        if payload.startswith(FABRIC_MAGIC):
            if len(payload) <= len(FABRIC_MAGIC):
                return 0
            kind = payload[len(FABRIC_MAGIC)]
            if kind in REMEDY_KINDS:
                rec = RemedyRecord.decode(kind, payload,
                                          len(FABRIC_MAGIC) + 1)
                return 0 if rec is None else self._judge_remedy(rec)
            if kind != Rec.PLACE:
                return 0
            place = Placement.decode(payload, len(FABRIC_MAGIC) + 1)
            if place is None:
                return 0
            # veto a record that disagrees with MY membership view —
            # the consensus only adopts routing the whole (converged)
            # fleet can execute; a vetoed round retries after the
            # views converge
            return 1 if set(place.members) == set(self.engine.group) \
                else 0
        prev_judge = self._prev_app[0]
        if prev_judge is None:
            return 1
        return prev_judge(payload, self._prev_app[2])

    def _judge_remedy(self, rec: RemedyRecord) -> int:
        """One rank's vote on a remediation record — the SAME
        predicate serves relay judgment and the proposer's pre-flight
        (docs/DESIGN.md §22). Vetoes protect two invariants:

          - membership coherence: a quarantine target I do not see as
            a member is an action my view contradicts (a mid-flap
            target retries after it rejoins; an un-quarantine of a
            dead rank would just re-arm the flap);
          - blast radius: quarantining may never leave fewer than
            ``remedy_min_alive`` live non-quarantined members (the
            min-alive quorum defaults to a STATIC-world majority, so
            a partitioned minority can never pass it — at most one
            side of a split can ever decide an action) and may never
            cover more than ``remedy_blast_frac`` of the group.
        """
        group = set(self.engine.group)
        if rec.kind == Rec.QUARANTINE:
            if rec.target not in group:
                return 0
            q_after = (self.quarantined | {rec.target}) & group
            if len(group - q_after) < self.remedy_min_alive:
                return 0
            cap = max(1, int(self.remedy_blast_frac * len(group)))
            if rec.target not in self.quarantined and \
                    len(q_after) > cap:
                return 0
            return 1
        if rec.kind == Rec.UNQUARANTINE:
            # lifting is only gated on liveness: un-quarantining a
            # rank nobody routes to anyway is harmless, but lifting a
            # DEAD rank's quarantine re-arms the flap
            return 1 if rec.target in group else 0
        if rec.kind == Rec.BACKPRESSURE:
            return 1 if 0 <= rec.level <= 16 else 0
        if rec.kind == Rec.REBALANCE:
            return 1
        return 0

    def _action(self, payload: bytes, ctx):
        if payload.startswith(FABRIC_MAGIC):
            kind = (payload[len(FABRIC_MAGIC)]
                    if len(payload) > len(FABRIC_MAGIC) else -1)
            if kind in REMEDY_KINDS:
                rec = RemedyRecord.decode(kind, payload,
                                          len(FABRIC_MAGIC) + 1)
                if rec is not None:
                    self._apply_remedy(rec)
                return None
            place = Placement.decode(payload, len(FABRIC_MAGIC) + 1)
            if place is not None:
                _, span = split_span_ctx(payload,
                                         len(FABRIC_MAGIC) + 1)
                self._adopt_place(place, span)
            return None
        prev_action = self._prev_app[1]
        if prev_action is None:
            return None
        return prev_action(payload, self._prev_app[2])

    def _adopt_place(self, place: Placement,
                     span: Optional[Tuple[int, int, int, int, int]]
                     = None) -> None:
        """Newest-wins adoption ((version, proposer) order): stale
        records re-flooded out of replaced views can never regress
        routing; equal-key records are byte-identical by construction
        (a proposer's epoch moves with every view change)."""
        if place.key() <= self.placement.key():
            return
        self.placement = place
        self._rebal_pending = False  # a fresh record satisfies it
        self.metrics.counter("fabric.placements_adopted").inc()
        self.metrics.gauge("fabric.placement_version").set(
            place.version)
        if self.spans is not None and span is not None and \
                span[0] & SPAN_F_SAMPLED:
            # fleet-level span keyed rid = (-1, placement version):
            # propose (the trailer's stamp) -> adopted here
            self.spans.emit((span[2], span[3]), Stage.PLACEMENT_IAR,
                            span[4] / 1e6, self.clock())

    def _propose_place(self, members: Tuple[int, ...]) -> None:
        place = Placement(version=self.engine.epoch,
                          proposer=self.rank, members=members)
        self._proposed = place
        self.metrics.counter("fabric.placements_proposed").inc()
        ctx = b""
        if self.spans is not None:
            t0 = int(round(self.clock() * 1e6))
            self._proposed_ctx = (SPAN_F_SAMPLED,
                                  int(Stage.PLACEMENT_IAR), -1,
                                  place.version & 0x7FFFFFFF, t0)
            ctx = encode_span_ctx(-1, place.version,
                                  Stage.PLACEMENT_IAR, t0)
        self.engine.submit_proposal(_enc_place(place, ctx),
                                    pid=self._my_place_pid)

    # ------------------------------------------------------------------
    # IAR face: remediation rounds (docs/DESIGN.md §22)
    # ------------------------------------------------------------------
    def next_remedy_version(self) -> int:
        """A version strictly above every remedy record this rank has
        seen (and at least the membership epoch): record ordering is
        newest-wins by (version, proposer), so proposals must outrank
        the state they intend to replace."""
        return max(self.engine.epoch, self._remedy_ver_max + 1)

    def propose_remedy(self, rec: RemedyRecord) -> bool:
        """Submit one remediation record through IAR. False when the
        engine's single proposal slot is busy (a placement or earlier
        remedy round in flight) — the policy retries next pump."""
        if self.engine.my_own_proposal.state == ReqState.IN_PROGRESS \
                or self._proposed is not None \
                or self._proposed_remedy is not None:
            return False
        self._proposed_remedy = rec
        self.metrics.counter("fabric.remedies_proposed").inc()
        self.engine.submit_proposal(_enc_remedy(rec),
                                    pid=self._my_remedy_pid)
        return True

    def _apply_remedy(self, rec: RemedyRecord) -> None:
        """Execute one DECIDED remediation record — idempotent and
        newest-wins per key-space (per-target for the quarantine
        kinds, fleet-wide for backpressure/rebalance), so decision
        fan-out, heal re-broadcasts and replays all converge to the
        same state in any order."""
        now = self.clock()
        if rec.version > self._remedy_ver_max:
            self._remedy_ver_max = rec.version
        if rec.kind in (Rec.QUARANTINE, Rec.UNQUARANTINE):
            cur = self._quar_ver.get(rec.target)
            if cur is not None and rec.key() <= cur:
                return
            self._quar_ver[rec.target] = rec.key()
            self._quar_recs[rec.target] = rec
            if rec.kind == Rec.QUARANTINE:
                self.quarantined.add(rec.target)
            else:
                self.quarantined.discard(rec.target)
            self.metrics.gauge("fabric.quarantined").set(
                len(self.quarantined))
        elif rec.kind == Rec.BACKPRESSURE:
            if self._bp_ver is not None and rec.key() <= self._bp_ver:
                return
            self._bp_ver = rec.key()
            self._bp_rec = rec
            self.bp_level = max(0, int(rec.level))
            self._bp_next_decay = (now + self.bp_window
                                   if self.bp_level else float("inf"))
            self.metrics.gauge("fabric.backpressure_level").set(
                self.bp_level)
        elif rec.kind == Rec.REBALANCE:
            if self._rebal_ver is not None and \
                    rec.key() <= self._rebal_ver:
                return
            self._rebal_ver = rec.key()
            self._rebal_pending = True
            self._next_place = float("-inf")
        else:
            return  # unknown remedy kind: forward-compat no-op
        self.metrics.counter("fabric.remedies_executed").inc()
        self.remedy_log.append(
            (now, Rec(rec.kind).name, rec.target, rec.level,
             len(self.engine.group), len(self.quarantined)))

    def _advisory_avoid(self) -> Tuple[int, ...]:
        """This rank's ADVISORY fail-over filter: members whose
        telemetry shows them badly behind (membership epoch lag over
        ``avoid_lag``) or silent (last digest older than
        ``avoid_stale``) — laggards that would sit on re-queued
        orphans. Advisory means per-rank and divergence-tolerant: the
        no-wedge fallbacks live in ``placement.owner_of``, and a rank
        NEVER avoids itself (the winner over the agreed set must
        always claim the work — that asymmetry is what bounds
        divergence cost at a duplicate decode)."""
        plane = self.telemetry
        if plane is None:
            return ()
        now = self.clock()
        my_epoch = self.engine.epoch
        out = []
        for r in self.placement.members:
            if r == self.rank:
                continue
            ent = plane.view.entries.get(r)
            if ent is None or ent.applied_seq < 0:
                continue  # never reported: no evidence either way
            if my_epoch - ent.epoch > self.avoid_lag or \
                    now - ent.updated > self.avoid_stale:
                out.append(r)
        return tuple(out)

    # ------------------------------------------------------------------
    # the pump (the fabric's progress turn)
    # ------------------------------------------------------------------
    def offer_record(self, m: UserMsg) -> bool:
        """Feed one engine pickup to the fabric's record dispatch;
        True when it was a fabric record or a placement-round outcome
        (consumed), False for the embedding app's traffic. The one
        classification ``pump()`` uses — harnesses that drain pickups
        themselves (FleetHarness.converge) route through this so
        records landing outside a pump are never dropped."""
        if m.type in (int(Tag.BCAST), int(Tag.SERVE)) and \
                m.data.startswith(FABRIC_MAGIC):
            self._on_record(m.data, m.origin)
            return True
        if m.type in (int(Tag.IAR_DECISION), int(Tag.ABORT)) and \
                (FABRIC_PID_BASE <= m.pid <
                 FABRIC_PID_BASE + self.engine.world_size or
                 REMEDY_PID_BASE <= m.pid <
                 REMEDY_PID_BASE + self.engine.world_size):
            # placement/remedy-round outcome: _action already applied
            # the decision (an abort just frees the pid for the retry
            # the staleness check / remedy policy schedules)
            return True
        return False

    def pump(self) -> List[UserMsg]:
        """One fabric turn: drain engine pickups, reconcile placement
        and ownership, run a decode round and the load gossip when
        due. Returns pickups that were not fabric records (the
        embedding application's traffic). No-op while the engine is
        mid-rejoin — a joiner's frames are quarantined fleet-wide, so
        acting on stale local state would only waste decode work."""
        eng = self.engine
        if eng.mid_rejoin:
            return []
        unhandled: List[UserMsg] = []
        while (m := eng.pickup_next()) is not None:
            if self.telemetry is not None and self.telemetry.offer(m):
                continue  # a Tag.TELEM digest: the plane consumed it
            if self.offer_record(m):
                continue
            # everything else — the embedding app's traffic,
            # INCLUDING Tag.FAILURE/foreign-abort notices (the
            # fabric reacts off the engine's adopted view, but the
            # app may be watching rank deaths through pickup)
            unhandled.append(m)

        # proposer-side adoption: the engine fires action_cb on relays
        # only; the proposer adopts its own approved record here
        p = eng.my_own_proposal
        if self._proposed is not None and \
                p.pid == self._my_place_pid and \
                p.state != ReqState.IN_PROGRESS:
            if p.state == ReqState.COMPLETED and p.vote:
                self._adopt_place(self._proposed, self._proposed_ctx)
            self._proposed = None  # declined/failed: retried below
            self._proposed_ctx = None
        if self._proposed_remedy is not None and \
                p.pid == self._my_remedy_pid and \
                p.state != ReqState.IN_PROGRESS:
            # proposer-side remedy adoption (action_cb fires on
            # relays only, like placement); declined/aborted rounds
            # go back to the policy, which retries or drops the want
            rec, self._proposed_remedy = self._proposed_remedy, None
            decided = bool(p.state == ReqState.COMPLETED and p.vote)
            if decided:
                self._apply_remedy(rec)
            if self.remedy is not None:
                self.remedy.on_outcome(rec, decided)

        now = self.clock()
        view = tuple(sorted(eng.group))
        if view != self._last_view:
            grown = set(view) - set(self._last_view)
            self._last_view = view
            if grown:
                # heal/admission re-sync: re-broadcast what the new
                # members may have missed; rid-level dedup absorbs
                # every duplicate (docs/DESIGN.md §11 exactly-once)
                self._rebroadcast()
        if set(self.placement.members) != set(view) or \
                self.placement.version < eng.epoch or \
                self._rebal_pending:
            # the agreed routing record trails the membership view —
            # wrong members, or decided before the latest view change
            # (the version-vs-epoch check is what re-converges a
            # rejoined rank whose fresh construction-time record
            # happens to name the right members): the lowest-ranked
            # member petitions a new record through IAR (anyone
            # could; one proposer avoids N identical concurrent
            # rounds)
            if self.rank == min(view) and now >= self._next_place \
                    and p.state != ReqState.IN_PROGRESS:
                self._next_place = now + self.place_retry
                self._rebal_pending = False
                self._propose_place(view)

        # AIMD backpressure: additive recovery (one level per clean
        # window) and the throttled drain of deferred admissions
        if self.bp_level > 0 and now >= self._bp_next_decay:
            self.bp_level -= 1
            self._bp_next_decay = (now + self.bp_window
                                   if self.bp_level else float("inf"))
            self.metrics.gauge("fabric.backpressure_level").set(
                self.bp_level)
        while self._admit_queue:
            if self.bp_level > 0 and now < self._next_admit:
                break
            if self.bp_level > 0:
                self._next_admit = now + self.bp_base * \
                    (2 ** (self.bp_level - 1))
            self._submit_now(*self._admit_queue.popleft())

        self._reconcile()

        if now >= self._next_decode and self.backend.has_work():
            self._next_decode = now + self.decode_interval
            completed = self.backend.step_round()
            self._observe_dequeues(now, completed)
            for rid, toks in completed:
                self._local.discard(rid)
                if rid in self.done:
                    # completed elsewhere while my round ran (an
                    # ownership race across a heal): genuinely
                    # duplicated decode work; the first completion
                    # won, never re-broadcast
                    self.dup_done += 1
                    self.metrics.counter("fabric.dup_decodes").inc()
                else:
                    self._complete(rid, toks)
        if now >= self._next_load:
            self._next_load = now + self.load_interval
            free, depth = self.backend.load()
            self._loads[self.rank] = (free, depth)
            raw = _enc_load(free, depth)
            for dst in view:
                if dst != self.rank:
                    eng.send_direct(dst, raw)
        if self.done_ttl is not None:
            self._evict_done(now)
        self.metrics.gauge("fabric.pending").set(len(self.requests))
        if self.telemetry is not None:
            self.telemetry.tick()
        if self.remedy is not None:
            # after tick(): the policy reads the watchdog trips this
            # very pump produced, so trip -> proposal is one turn
            self.remedy.step()
        return unhandled

    def _observe_dequeues(self, now: float,
                          completed: Sequence[Tuple[Rid, tuple]]
                          ) -> None:
        """Queue->active boundary bookkeeping after a decode round:
        the first round that runs a request here ends its queue
        residency. Always on (the ``fabric.queue_wait_usec`` /
        ``fabric.ttft_usec`` parity twins of the server-side
        ``serve.queue_wait_usec``, on the engine clock); the queue
        SPAN is emitted only for traced rids. A request that finished
        within its first round shows up in ``completed`` rather than
        ``active_keys()`` — its queue ended when this round ran."""
        newly = list(self.backend.active_keys())
        newly += [rid for rid, _ in completed]
        for rid in newly:
            req = self.requests.get(rid)
            if req is None or req.t_active is not None or \
                    rid not in self._local:
                continue
            req.t_active = now
            self.metrics.histogram("fabric.queue_wait_usec").observe(
                (now - req.t_enq) * 1e6)
            self.metrics.histogram("fabric.ttft_usec").observe(
                (now - req.t_admit) * 1e6)
            if self.spans is not None and req.traced:
                self.spans.emit(rid, Stage.QUEUE, req.t_enq, now)

    def _evict_done(self, now: float) -> None:
        """Age the completion cache past the ``done_ttl`` horizon (the
        order deque is completion-ordered, so this pops only expired
        heads — O(evicted), not O(table))."""
        horizon = now - self.done_ttl
        evicted = 0
        while self._done_order and self._done_order[0][0] <= horizon:
            _, rid = self._done_order.popleft()
            if self.done.pop(rid, None) is not None:
                self.done_by.pop(rid, None)
                if len(self._evicted_ring) == self._evicted_ring.maxlen:
                    self._evicted.discard(self._evicted_ring[0])
                self._evicted_ring.append(rid)
                self._evicted.add(rid)
                evicted += 1
        if evicted:
            self.metrics.counter("fabric.done_evicted").inc(evicted)

    # ------------------------------------------------------------------
    # record handling
    # ------------------------------------------------------------------
    def _on_record(self, data: bytes, origin: int) -> None:
        if len(data) <= len(FABRIC_MAGIC):
            # a magic-only (or truncated) frame: the caller's
            # startswith(FABRIC_MAGIC) proves nothing about the kind
            # byte existing — without this guard a 5-byte payload
            # raises IndexError inside every rank's pump
            # (rlo-sentinel S2)
            self.metrics.counter("fabric.unknown_records").inc()
            return
        kind = data[len(FABRIC_MAGIC)]
        body = data[len(FABRIC_MAGIC) + 1:]
        if kind == Rec.ADMIT:
            self._on_admit(body, origin)
        elif kind == Rec.DONE:
            self._on_done(body)
        elif kind == Rec.PLACE:
            # an in-band placement record (e.g. a future re-flood
            # path): newest-wins adoption is idempotent
            place = Placement.decode(body)
            if place is not None:
                _, span = split_span_ctx(body, 0)
                self._adopt_place(place, span)
        elif kind == Rec.LOAD:
            if len(body) >= 8:
                self._loads[origin] = struct.unpack_from("<ii", body)
        elif kind == Rec.QUARANTINE:
            # an in-band remedy record (heal re-broadcast): execution
            # is newest-wins idempotent, same as the decision path
            rec = RemedyRecord.decode(kind, body)
            if rec is not None:
                self._apply_remedy(rec)
        elif kind == Rec.UNQUARANTINE:
            rec = RemedyRecord.decode(kind, body)
            if rec is not None:
                self._apply_remedy(rec)
        elif kind == Rec.BACKPRESSURE:
            rec = RemedyRecord.decode(kind, body)
            if rec is not None:
                self._apply_remedy(rec)
        elif kind == Rec.REBALANCE:
            rec = RemedyRecord.decode(kind, body)
            if rec is not None:
                self._apply_remedy(rec)
        else:
            self.metrics.counter("fabric.unknown_records").inc()

    def _on_admit(self, body: bytes, origin: int) -> None:
        if len(body) < 20:
            return
        end, span = split_span_ctx(body, 20)
        g, s, owner, max_new, eos = struct.unpack_from("<iiiii", body)
        n = (end - 20) // 4
        prompt = struct.unpack_from(f"<{n}i", body, 20)
        rid: Rid = (g, s)
        if rid in self.done:
            # a re-admission of a completed request (the admitter
            # missed the DONE): answer with the completion directly
            if origin != self.rank and origin in self.engine.group:
                self.engine.send_direct(
                    origin, _enc_done(rid, self.done_by.get(rid, -1),
                                      self.done[rid]))
            return
        if rid in self._evicted:
            # completed here but aged out of the done_ttl cache: the
            # tokens are gone, so there is nothing to answer with —
            # but re-admitting would re-decode a settled request
            return
        if rid in self.requests:
            return  # duplicate admission: rid-level exactly-once
        self._apply_admit(rid, owner, max_new, eos, prompt, span)

    def _apply_admit(self, rid: Rid, owner: int, max_new: int,
                     eos: int, prompt: Tuple[int, ...],
                     span: Optional[Tuple[int, int, int, int, int]]
                     = None) -> None:
        now = self.clock()
        req = _FabReq(prompt, max_new, eos, rid[0], owner, now)
        self.requests[rid] = req
        self.metrics.counter("fabric.requests_admitted").inc()
        if self.spans is not None and span is not None and \
                span[0] & SPAN_F_SAMPLED:
            # admission broadcast span: gateway submit (the trailer's
            # stamp) -> this rank applied the ADMIT
            req.traced = True
            self.spans.emit(rid, Stage.ADMIT_BCAST, span[4] / 1e6,
                            now)

    def _on_done(self, body: bytes) -> None:
        if len(body) < 12:
            return
        end, span = split_span_ctx(body, 12)
        g, s, decoder = struct.unpack_from("<iii", body)
        n = (end - 12) // 4
        toks = struct.unpack_from(f"<{n}i", body, 12)
        self._record_done((g, s), decoder, toks, span)

    def _complete(self, rid: Rid, toks: Tuple[int, ...]) -> None:
        """My backend finished ``rid``: record + broadcast the DONE."""
        ctx = b""
        span = None
        if self.spans is not None:
            req = self.requests.get(rid)
            if req is not None and req.traced:
                now = self.clock()
                start = req.t_enq if req.t_active is None \
                    else req.t_active
                self.spans.emit(rid, Stage.DECODE_ROUND, start, now)
                t0 = int(round(now * 1e6))
                span = (SPAN_F_SAMPLED, int(Stage.DELIVER), rid[0],
                        rid[1] & 0x7FFFFFFF, t0)
                ctx = encode_span_ctx(rid[0], rid[1], Stage.DELIVER,
                                      t0)
        self._record_done(rid, self.rank, toks, span)
        self.engine.bcast(_enc_done(rid, self.rank, toks, ctx))

    def _record_done(self, rid: Rid, decoder: int,
                     toks: Tuple[int, ...],
                     span: Optional[Tuple[int, int, int, int, int]]
                     = None) -> None:
        if rid in self.done or rid in self._evicted:
            # a DONE copy for a settled rid (heal re-broadcasts, a
            # direct reply racing the broadcast, or a replay for a rid
            # the done_ttl cache already evicted): exactly-once means
            # the first one won. Absorbed copies are bookkeeping, not
            # wasted decode work — that is fabric.dup_decodes.
            self.metrics.counter("fabric.done_copies").inc()
            # a replayed ADMIT may have ghost-revived the request
            # before this tombstoned DONE copy arrived: retire it
            if self.requests.pop(rid, None) is not None and \
                    rid in self._local:
                self.backend.cancel(rid)
                self._local.discard(rid)
            return
        self.done[rid] = tuple(toks)
        self.done_by[rid] = decoder
        self.completions.append(rid)
        self._recent_done.append(rid)
        if self.done_ttl is not None:
            self._done_order.append((self.clock(), rid))
        self.metrics.counter("fabric.requests_completed").inc()
        req = self.requests.pop(rid, None)  # evict: decoded == done
        if req is not None:
            now = self.clock()
            self.metrics.histogram("fabric.e2e_usec").observe(
                (now - req.t_admit) * 1e6)
            if self.spans is not None and req.traced and \
                    span is not None and rid[0] == self.rank:
                # gateway-side delivery span: owner DONE broadcast
                # (the trailer's stamp) -> delivered here
                self.spans.emit(rid, Stage.DELIVER, span[4] / 1e6,
                                now)
        if rid in self._local:
            # completed elsewhere first: stop decoding it here
            self.backend.cancel(rid)
            self._local.discard(rid)

    # ------------------------------------------------------------------
    # ownership reconciliation + re-sync
    # ------------------------------------------------------------------
    def _reconcile(self) -> None:
        """Align my backend with the agreed placement: enqueue every
        pending request the current record says is mine (counting the
        ones I picked up from a departed owner — the re-queue), and
        withdraw the ones whose ownership moved away. Ownership is
        health-aware (docs/DESIGN.md §22): the agreed quarantine set
        filters candidates everywhere identically, and this rank's
        advisory FleetView filter steers fail-over away from laggards
        (never from itself — see placement.owner_of for why that
        asymmetry cannot wedge)."""
        avoid = self._advisory_avoid()
        for rid, req in self.requests.items():
            owner = owner_of(rid, req.owner, self.placement,
                             quarantined=self.quarantined,
                             avoid=avoid)
            if owner == self.rank:
                if rid not in self._local:
                    if req.owner != self.rank:
                        self.requeues += 1
                        self.metrics.counter("fabric.requeued").inc()
                        # failover lineage: the re-queue restarts the
                        # queue clock; the zero-duration marker is the
                        # link between the dead owner's last stage and
                        # the new owner's queue span
                        req.t_enq = self.clock()
                        req.t_active = None
                        if self.spans is not None and req.traced:
                            self.spans.emit(rid, Stage.REQUEUE,
                                            req.t_enq, req.t_enq)
                    self.backend.submit(
                        rid, req.prompt, req.max_new,
                        None if req.eos_id < 0 else req.eos_id)
                    self._local.add(rid)
            elif rid in self._local:
                self.backend.cancel(rid)
                self._local.discard(rid)
                self.metrics.counter("fabric.ownership_moved").inc()

    def _rebroadcast(self) -> None:
        """Members joined my view (heal / admission / my own rejoin):
        re-broadcast every pending ADMIT and the recent DONE ring so
        they converge on the request state. Dedup by rid makes every
        copy idempotent; the cost is O(pending + ring) broadcasts per
        view growth (documented §11 scaling note)."""
        for rid, req in self.requests.items():
            self.metrics.counter("fabric.readmitted").inc()
            self.engine.bcast(_enc_admit(rid, req.owner, req.max_new,
                                         req.eos_id, req.prompt))
        for rid in list(self._recent_done):
            toks = self.done.get(rid)
            if toks is None:
                continue  # aged out of the completion cache (done_ttl)
            self.engine.bcast(_enc_done(rid, self.done_by.get(rid, -1),
                                        toks))
        # remediation catch-up: a restarted victim rebuilds with an
        # empty remedy state and must learn its OWN quarantine (and
        # the fleet's backpressure level) from the survivors; newest-
        # wins keys make every copy idempotent
        for target in sorted(self._quar_recs):
            self.engine.bcast(_enc_remedy(self._quar_recs[target]))
        if self._bp_rec is not None:
            self.engine.bcast(_enc_remedy(self._bp_rec))

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def attach_telemetry(self, plane) -> None:
        """Join the in-band telemetry plane (docs/DESIGN.md §17):
        ``pump()`` feeds the plane its Tag.TELEM pickups and ticks it
        once per turn, and the plane's digest extras come from this
        fabric's paged-pool occupancy (``telemetry_extra``) unless the
        plane already has an extras source."""
        if plane.engine is not self.engine:
            raise ValueError("telemetry plane must share this "
                             "fabric's engine")
        if plane.extra is None:
            plane.extra = self.telemetry_extra
        self.telemetry = plane

    def telemetry_extra(self) -> dict:
        """Digest extras for the TELEM schema's serving keys: the
        paged pool's occupancy when this rank's backend has one, plus
        the latency block rlo-top's ``--serve`` view renders —
        in-flight requests on this rank's backend and the p50/p99 of
        the fabric TTFT / e2e histograms (log2-bucket estimates,
        zero while empty; the schema is fixed fleet-wide and the C
        engine emits zeros for all of these)."""
        pages = self.backend.stats().get("pages")
        out = {"pages_in_use": 0, "pages_free": 0}
        if isinstance(pages, dict):
            out["pages_in_use"] = int(pages.get("pages_in_use", 0))
            out["pages_free"] = int(pages.get("pages_free", 0))
        out["serve_inflight"] = len(self._local)
        ttft = self.metrics.histogram("fabric.ttft_usec")
        e2e = self.metrics.histogram("fabric.e2e_usec")
        out["ttft_p50_usec"] = int(ttft.p50() or 0)
        out["ttft_p99_usec"] = int(ttft.p99() or 0)
        out["e2e_p50_usec"] = int(e2e.p50() or 0)
        out["e2e_p99_usec"] = int(e2e.p99() or 0)
        out["remedies_proposed"] = \
            self.metrics.counter("fabric.remedies_proposed").value
        out["remedies_executed"] = \
            self.metrics.counter("fabric.remedies_executed").value
        out["quarantined"] = len(self.quarantined)
        out["backpressure_level"] = self.bp_level
        return out

    def stats(self) -> dict:
        """Per-rank fabric snapshot: counters/gauges verbatim,
        histograms as percentile summaries (the DecodeServer.stats()
        convention), plus placement and backend state."""
        snap = self.metrics.snapshot()
        snap["histograms"] = {k: hist_summary(h)
                              for k, h in snap["histograms"].items()}
        snap["placement"] = {"version": self.placement.version,
                             "proposer": self.placement.proposer,
                             "members": list(self.placement.members)}
        snap["pending"] = len(self.pending())
        snap["completions"] = len(self.completions)
        snap["requeues"] = self.requeues
        snap["dup_done"] = self.dup_done
        snap["remedy"] = {
            "quarantined": sorted(self.quarantined),
            "backpressure_level": self.bp_level,
            "admit_queue": len(self._admit_queue),
            "log": list(self.remedy_log),
            "policy": (None if self.remedy is None
                       else self.remedy.stats()),
        }
        snap["backend"] = self.backend.stats()
        return snap


def fleet_stats(fabrics: Sequence[DecodeFabric],
                view=None) -> dict:
    """Fleet-level rollup over live fabric nodes: summed counters, a
    merged end-to-end latency summary (submit -> last token, re-queue
    and fail-over time included — the first-class fail-over-cost
    metric), and the per-rank snapshots.

    This is a CONSUMER of the observe layer's merge
    helpers (rlo_tpu_torch/observe/telemetry.py) rather than a bespoke
    merge, and it composes with the in-band telemetry plane: pass a
    :class:`~rlo_tpu_torch.observe.FleetView` (or any of the attached
    planes' ``.view``) as ``view`` and the rollup gains a
    ``fleet_view`` block — the ENGINE-level fleet picture (frames,
    retransmits, heal-cost counters, page occupancy) as seen from one
    rank, digest coverage and staleness included."""
    from rlo_tpu_torch.observe.telemetry import (merge_counter_dicts,
                                                 merge_histograms)
    snaps = [f.metrics.snapshot() for f in fabrics]
    out = {
        "counters": merge_counter_dicts(
            [s["counters"] for s in snaps]),
        "e2e_usec": merge_histograms(
            [s["histograms"].get("fabric.e2e_usec") for s in snaps]),
        "queue_wait_usec": merge_histograms(
            [s["histograms"].get("fabric.queue_wait_usec")
             for s in snaps]),
        "ranks": {str(f.rank): f.stats() for f in fabrics},
    }
    if view is None and fabrics:
        plane = fabrics[0].telemetry
        if plane is not None:
            view = plane.view
    if view is not None:
        clock = fabrics[0].clock if fabrics else (lambda: 0.0)
        epoch = fabrics[0].engine.epoch if fabrics else None
        out["fleet_view"] = view.snapshot(clock(), self_epoch=epoch)
    return out
