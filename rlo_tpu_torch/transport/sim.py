"""Deterministic discrete-event network simulator (docs/DESIGN.md §8).

The port's own copy of ``rlo_tpu/transport/sim.py``, line for line: only
the imports and the logger names differ, so both packages give the same
results and the same bytes for the same seed
(``tests/test_torch_sim.py`` holds them equal).

FoundationDB-style simulation testing for the membership/reliability
stack: N progress engines run single-threaded over one seeded event
queue that owns EVERY delivery-order, delay, drop, duplication, and
partition decision. The loopback world (loopback.py) perturbs order
with a seeded per-poll tick; this simulator goes further — virtual
time is advanced ONLY by the event queue (engines take ``clock=
world.clock``), so heartbeat timeouts, ARQ retransmits, op deadlines,
and JOIN probe cadences are all replayed bit-for-bit from the seed.
``schedule_digest()`` hashes the full delivery schedule; the replay
test asserts same seed => byte-identical schedule.

Fault script steps (``Scenario``): ``partition(groups)`` /
``heal()`` / ``kill(rank)`` / ``restart(rank)`` (fresh engine with a
bumped incarnation -> JOIN/admission rejoin), plus loss-rate windows.
On a property violation (duplicate pickup, lost delivery, hung op,
divergent membership) the scenario raises ``SimViolation`` carrying
the seed and the one-line ``Scenario(...)`` call that replays it.

The simulated network model: per-(src, dst) FIFO (delays are clamped
monotone per channel, matching MPI and the real transports), iid
delay in [min_delay, max_delay], iid drop/dup by rate, and
group-partition drops applied at DELIVERY time (frames in flight when
the partition lands are lost, like a real link going dark).
"""

from __future__ import annotations

import bisect
import copy
import hashlib
import heapq
import itertools
import struct
from random import Random
from typing import Dict, List, Optional, Sequence, Tuple

from rlo_tpu_torch.transport.base import (FAILED_SEND, SendHandle, Transport,
                                          register_transport)


# ---------------------------------------------------------------------------
# Event schedulers: the heapq oracle and the calendar queue
# (docs/DESIGN.md §14). Both order items — tuples whose layout is
# (t, ctr, ...) with a globally unique ctr — by (t, ctr), so pop order
# is total and BYTE-IDENTICAL between the two implementations,
# timestamp ties included (the tie always resolves by insertion
# counter before any later tuple field is ever compared).
# ---------------------------------------------------------------------------

class HeapScheduler:
    """The reference binary-heap event queue — kept as the oracle the
    calendar queue is equivalence-tested against (and the default:
    small worlds gain nothing from slotting)."""

    __slots__ = ("_heap",)

    def __init__(self):
        self._heap: List = []

    def push(self, item) -> None:
        heapq.heappush(self._heap, item)

    def pop(self):
        return heapq.heappop(self._heap)

    def items(self) -> List:
        """Every queued item, sorted by pop order (t, ctr) — the
        rlo-model explorer's view of the in-flight frame set."""
        return sorted(self._heap)

    def remove(self, item) -> None:
        """Delete one specific queued item (rlo-model targeted
        deliver/drop/dup). O(n) — explorer worlds are tiny."""
        self._heap.remove(item)
        heapq.heapify(self._heap)

    def __len__(self) -> int:
        return len(self._heap)


class CalendarScheduler:
    """Slotted calendar queue with an overflow heap — O(1) amortized
    push/pop against heapq's O(log n), which is what lets protocol-only
    sweeps reach n >= 10,000 simulated ranks (docs/DESIGN.md §14).

    A ring of ``nslots`` buckets, each ``width`` virtual seconds wide,
    covers the rotating window ``[base, base + nslots*width)`` where
    ``base = _slot_no * width``. Items inside the window live in their
    slot's sorted list (``bisect.insort``; slots hold a handful of
    items at the simulator's densities). Items past the window land in
    the overflow heap and MIGRATE into the ring as the window advances
    — the invariant after every operation is that nothing in the
    overflow is due inside the current window, so the head of the
    first nonempty slot is always the global minimum.

    Pop-order contract: identical to :class:`HeapScheduler` for any
    push sequence, equal timestamps included — items are full tuples
    ordered by (t, ctr) and ctr is unique, so both structures sort by
    exactly the same total order (tested under randomized timestamp
    ties in tests/test_workloads.py; the SimWorld schedule digest is
    scheduler-independent).
    """

    __slots__ = ("width", "nslots", "_ring", "_count", "_slot_no",
                 "_overflow")

    def __init__(self, width: float, nslots: int = 256):
        if width <= 0.0 or nslots < 2:
            raise ValueError(f"need width > 0 and nslots >= 2, got "
                             f"{width}, {nslots}")
        self.width = width
        self.nslots = nslots
        self._ring: List[List] = [[] for _ in range(nslots)]
        self._count = 0            # items resident in the ring
        self._slot_no = 0          # absolute slot index of the cursor
        self._overflow: List = []  # heap of beyond-window items

    def _migrate(self) -> None:
        """Pull every overflow item now due inside the window into its
        ring slot (called after any cursor advance/jump)."""
        horizon = (self._slot_no + self.nslots) * self.width
        ov = self._overflow
        while ov and ov[0][0] < horizon:
            item = heapq.heappop(ov)
            bisect.insort(self._ring[int(item[0] // self.width)
                                     % self.nslots], item)
            self._count += 1

    def push(self, item) -> None:
        t = item[0]
        sn = int(t // self.width)
        if sn >= self._slot_no + self.nslots:
            heapq.heappush(self._overflow, item)
            return
        if sn < self._slot_no:
            # floating-point guard: virtual time is monotone, so an
            # item can never be due before the cursor's slot — clamp
            # into the current slot (sorted insert keeps order exact)
            sn = self._slot_no
        bisect.insort(self._ring[sn % self.nslots], item)
        self._count += 1

    def pop(self):
        if self._count == 0:
            if not self._overflow:
                raise IndexError("pop from empty CalendarScheduler")
            # ring drained: jump the window straight to the overflow
            # minimum instead of crawling empty slots
            self._slot_no = int(self._overflow[0][0] // self.width)
            self._migrate()
        while True:
            slot = self._ring[self._slot_no % self.nslots]
            if slot:
                self._count -= 1
                return slot.pop(0)
            self._slot_no += 1
            self._migrate()

    def items(self) -> List:
        """Every queued item, sorted by pop order (t, ctr) — same
        contract as :meth:`HeapScheduler.items`."""
        out: List = []
        for slot in self._ring:
            out.extend(slot)
        out.extend(self._overflow)
        return sorted(out)

    def remove(self, item) -> None:
        """Delete one specific queued item — same contract as
        :meth:`HeapScheduler.remove`."""
        for slot in self._ring:
            if item in slot:
                slot.remove(item)
                self._count -= 1
                return
        if item in self._overflow:
            self._overflow.remove(item)
            heapq.heapify(self._overflow)
            return
        raise ValueError("item not queued")

    def __len__(self) -> int:
        return self._count + len(self._overflow)


class _SimSend(SendHandle):
    __slots__ = ("delivered", "failed")

    def __init__(self):
        self.delivered = False
        # the slot shadows the base-class default, so it must be
        # initialized for the documented failed-is-False contract
        self.failed = False

    def done(self) -> bool:
        return self.delivered


class SimTransport(Transport):
    def __init__(self, world: "SimWorld", rank: int):
        self.world = world
        self.rank = rank
        self.world_size = world.world_size

    def isend(self, dst: int, tag: int, data: bytes) -> SendHandle:
        return self.world._send(self.rank, dst, tag, data)

    def poll(self) -> Optional[Tuple[int, int, bytes]]:
        return self.world._poll(self.rank)


@register_transport("sim")
class SimWorld:
    """Seeded event-queue world for ``world_size`` in-process ranks.

    Unlike the loopback world, polling NEVER advances time: call
    ``step()`` (deliver the next scheduled frame, or advance idle
    time by ``idle_dt`` when nothing is in flight) and then progress
    the engines. All randomness comes from one ``random.Random(seed)``
    consumed in a deterministic order, so the whole run — including
    every engine decision driven by the injected clock — replays
    exactly from the seed.
    """

    def __init__(self, world_size: int, seed: int = 0,
                 min_delay: float = 0.001, max_delay: float = 0.25,
                 drop_p: float = 0.0, dup_p: float = 0.0,
                 idle_dt: float = 0.05, protocol_only: bool = False,
                 scheduler: str = "heap",
                 delay_fn=None, drop_fn=None):
        """``protocol_only`` is the fleet-scale fast path (ROADMAP item
        4 / docs/DESIGN.md §10): payloads are passed by reference
        (no defensive copy) and the SHA-256 schedule digest is skipped
        — the two per-frame costs that dominate at n >= 1024 simulated
        ranks. Delivery order, delays, drops and every engine decision
        stay seed-deterministic; only ``schedule_digest()`` (which
        returns the "protocol-only" sentinel) is given up, so replay
        ASSERTIONS need the full mode while scaling CURVES
        (benchmarks/sim_bench.py) use this one.

        ``scheduler`` selects the event queue: ``"heap"`` (the heapq
        oracle, default) or ``"calendar"`` (slotted calendar queue +
        overflow heap — the n >= 10k fast path). Pop order is
        byte-identical between the two, ties included, so every
        schedule digest and seed-exact metric is scheduler-independent
        (docs/DESIGN.md §14).

        ``delay_fn`` / ``drop_fn`` are the network-weather hooks
        (rlo_tpu_torch/workloads/weather.py): ``delay_fn(rng) -> delay``
        replaces the uniform [min_delay, max_delay] draw (the
        per-channel FIFO clamp still applies), ``drop_fn(rng) -> bool``
        replaces the iid ``drop_p`` coin (it may keep state — burst
        loss — but must draw randomness ONLY from the passed rng).
        Both default to None = the historical draws, byte-identical."""
        if world_size < 2:
            raise ValueError(f"world_size must be >= 2, got {world_size}")
        if not 0.0 < min_delay <= max_delay:
            raise ValueError("need 0 < min_delay <= max_delay")
        self.world_size = world_size
        self.seed = seed
        self.rng = Random(seed)
        self.now = 0.0
        self.min_delay = min_delay
        self.max_delay = max_delay
        self.drop_p = drop_p
        self.dup_p = dup_p
        self.idle_dt = idle_dt
        self.dead: set = set()
        self._group: Optional[Dict[int, int]] = None  # rank -> group id
        if scheduler == "heap":
            self._q = HeapScheduler()
        elif scheduler == "calendar":
            # slot width sized so the delay band spans a few slots and
            # the window covers it many times over; heartbeat-cadence
            # far-future pushes ride the overflow heap
            self._q = CalendarScheduler(width=max(max_delay / 64.0,
                                                  1e-9))
        else:
            raise ValueError(f"unknown scheduler {scheduler!r}; "
                             f"known: 'heap', 'calendar'")
        self.scheduler = scheduler
        self.delay_fn = delay_fn
        self.drop_fn = drop_fn
        self._ctr = itertools.count()
        self._chan_last: Dict[Tuple[int, int], float] = {}
        self.inboxes: List = [list() for _ in range(world_size)]
        self._inbox_pos = [0] * world_size
        self.sent_cnt = 0
        self.delivered_cnt = 0
        self.dropped_cnt = 0
        self.duplicated_cnt = 0
        self.events = 0  # schedule length (delivery attempts)
        self.protocol_only = protocol_only
        self._digest = None if protocol_only else hashlib.sha256()
        #: rank that received the last step()'s frame (None on idle
        #: ticks and dropped deliveries) — lets a bench loop step
        #: only the engine with fresh input instead of all n
        self.last_dst: Optional[int] = None
        self.transports = [SimTransport(self, r)
                           for r in range(world_size)]

    def transport(self, rank: int) -> SimTransport:
        return self.transports[rank]

    def clock(self) -> float:
        """Injectable engine clock: the simulator's virtual time."""
        return self.now

    # -- internals ---------------------------------------------------------
    def _send(self, src: int, dst: int, tag: int,
              data: bytes) -> SendHandle:
        if not 0 <= dst < self.world_size:
            raise ValueError(f"bad destination rank {dst}")
        if src in self.dead or dst in self.dead:
            return FAILED_SEND
        # weather hooks: drop_fn/delay_fn replace (never wrap) the
        # historical draws, consuming self.rng in the same call slots
        # — with both None the rng stream is byte-identical to always
        if self.drop_fn is not None:
            if self.drop_fn(self.rng):
                self.dropped_cnt += 1
                return FAILED_SEND
        elif self.drop_p and self.rng.random() < self.drop_p:
            self.dropped_cnt += 1
            return FAILED_SEND
        copies = 1
        if self.dup_p and self.rng.random() < self.dup_p:
            copies = 2
            self.duplicated_cnt += 1
        # per-channel FIFO: a later frame never overtakes an earlier
        # one on the same (src, dst) edge (matching MPI and every real
        # transport here); cross-channel order is exactly what the
        # seeded delays perturb
        t = self.now + (self.delay_fn(self.rng)
                        if self.delay_fn is not None
                        else self.rng.uniform(self.min_delay,
                                              self.max_delay))
        last = self._chan_last.get((src, dst), 0.0)
        if t < last:
            t = last
        self._chan_last[(src, dst)] = t
        h = _SimSend()
        # protocol-only fast path: skip the defensive copy — engines
        # hand in immutable bytes and never alias them afterwards
        payload = data if self.protocol_only else bytes(data)
        for _ in range(copies):
            self._q.push((t, next(self._ctr), src, dst, tag, payload,
                          h))
        self.sent_cnt += 1
        return h

    def _poll(self, rank: int) -> Optional[Tuple[int, int, bytes]]:
        if rank in self.dead:
            return None
        box = self.inboxes[rank]
        pos = self._inbox_pos[rank]
        if pos >= len(box):
            if box:
                box.clear()
                self._inbox_pos[rank] = 0
            return None
        self._inbox_pos[rank] = pos + 1
        return box[pos]

    def step(self) -> bool:
        """Deliver the next scheduled frame (True), or — with nothing
        in flight — advance idle time by ``idle_dt`` (False) so
        time-driven machinery (heartbeats, RTOs, deadlines, JOIN
        probes) keeps firing."""
        self.last_dst = None
        if not len(self._q):
            self.now += self.idle_dt
            return False
        t, _, src, dst, tag, data, h = self._q.pop()
        if t > self.now:
            self.now = t
        h.delivered = True
        self.events += 1
        dropped = (src in self.dead or dst in self.dead or
                   (self._group is not None and
                    self._group.get(src, -1 - src) !=
                    self._group.get(dst, -1 - dst)))
        # the digest covers every delivery ATTEMPT (time, edge, tag,
        # outcome, payload): two runs with one seed must make the
        # identical sequence of decisions, drops included (skipped
        # entirely on the protocol-only fast path)
        if self._digest is not None:
            self._digest.update(struct.pack("<diiii", t, src, dst, tag,
                                            0 if dropped else 1))
            self._digest.update(data)
        if dropped:
            h.failed = True
            self.dropped_cnt += 1
            return True
        self.inboxes[dst].append((src, tag, data))
        self.delivered_cnt += 1
        self.last_dst = dst
        return True

    def schedule_digest(self) -> str:
        """SHA-256 over the delivery schedule so far (see step());
        the "protocol-only" sentinel when the fast path disabled it."""
        if self._digest is None:
            return "protocol-only"
        return self._digest.hexdigest()

    def pending_events(self) -> int:
        """Scheduled-but-undelivered frame count — O(1) (both
        schedulers keep a live length). Scenario property-violation
        messages carry it next to the seed/replay recipe so a wedged
        run is distinguishable from a drained one at a glance."""
        return len(self._q)

    def quiescent(self) -> bool:
        return not len(self._q) and all(
            self._inbox_pos[r] >= len(self.inboxes[r])
            for r in range(self.world_size))

    # -- fault script controls --------------------------------------------
    def partition(self, groups: Sequence[Sequence[int]]) -> None:
        """Split the network: frames whose endpoints land in different
        groups are dropped at delivery time (frames already in flight
        across the cut are lost too). Ranks not named fall into
        singleton groups."""
        gmap: Dict[int, int] = {}
        for gi, g in enumerate(groups):
            for r in g:
                if not 0 <= r < self.world_size:
                    raise ValueError(f"bad rank {r} in partition")
                if r in gmap:
                    raise ValueError(f"rank {r} in two groups")
                gmap[r] = gi
        self._group = gmap

    def heal(self) -> None:
        """Remove the partition; traffic flows everywhere again."""
        self._group = None

    def kill_rank(self, rank: int) -> None:
        """Crash-stop: inbox discarded, in-flight frames to/from it
        die at delivery, future sends involving it vanish."""
        if not 0 <= rank < self.world_size:
            raise ValueError(f"bad rank {rank}")
        self.dead.add(rank)
        self.inboxes[rank].clear()
        self._inbox_pos[rank] = 0

    def restart_rank(self, rank: int) -> None:
        """Revive a killed rank's endpoint with an empty inbox (the
        harness then builds a fresh engine with a bumped incarnation)."""
        self.dead.discard(rank)
        self.inboxes[rank].clear()
        self._inbox_pos[rank] = 0
        # fresh process, fresh channels: no stale FIFO clamp
        for chan in [c for c in self._chan_last
                     if c[0] == rank or c[1] == rank]:
            del self._chan_last[chan]

    # -- explicit-state exploration hooks (rlo-model, DESIGN.md §20) -------
    def snapshot(self, *attached):
        """Deterministic state snapshot for DFS exploration: ONE
        deepcopy of this world plus any attached objects (engines,
        manager, harness bookkeeping) in a single memo, so every
        cross-reference — engine clocks bound to this world, in-flight
        ``SendHandle``s shared between the event queue and engine ARQ
        state, transports — stays internally consistent inside the
        copy. Returns ``(world_copy, *attached_copies)``; "restore" is
        simply continuing from the returned bundle (functional style:
        one snapshot can seed any number of divergent branches, each
        via its own fresh ``snapshot()`` of the bundle).

        The schedule digest is carried across via ``hashlib``'s own
        ``copy()`` (sha256 objects reject deepcopy)."""
        digest = self._digest
        self._digest = None
        try:
            clone = copy.deepcopy((self,) + attached)
        finally:
            self._digest = digest
        clone[0]._digest = None if digest is None else digest.copy()
        return clone

    def pending_frames(self) -> List:
        """Scheduled-but-undelivered frames as raw queue items
        ``(t, ctr, src, dst, tag, payload, handle)`` sorted by pop
        order. Read-only view; pair with :meth:`force_step`."""
        return self._q.items()

    def channel_heads(self) -> List:
        """The earliest pending frame per (src, dst) channel — the
        set of frames deliverable next without violating per-channel
        FIFO. This is the rlo-model explorer's branch alphabet: any
        interleaving of channel heads is a schedule the real network
        could produce."""
        heads: Dict[Tuple[int, int], tuple] = {}
        for it in self._q.items():
            key = (it[2], it[3])
            if key not in heads:   # items() is pop-ordered
                heads[key] = it
        return [heads[k] for k in sorted(heads)]

    def force_step(self, item, action: str = "deliver") -> None:
        """Deliver, drop, or duplicate one SPECIFIC pending frame now
        (it must be a value from :meth:`pending_frames` /
        :meth:`channel_heads`). The model checker uses this to explore
        a chosen interleaving instead of the seeded time order; time
        advances monotonically to the frame's due time exactly as
        :meth:`step` would. ``drop`` consumes the frame and fails its
        send handle (a targeted message-loss fault); ``dup`` delivers
        it AND re-queues a copy (a targeted duplication fault)."""
        if action not in ("deliver", "drop", "dup"):
            raise ValueError(f"unknown force_step action {action!r}")
        self._q.remove(item)
        t, _, src, dst, tag, data, h = item
        self.last_dst = None
        if t > self.now:
            self.now = t
        self.events += 1
        if action == "drop":
            if self._digest is not None:
                self._digest.update(struct.pack(
                    "<diiii", t, src, dst, tag, 0))
                self._digest.update(data)
            h.failed = True
            self.dropped_cnt += 1
            return
        if action == "dup":
            self._q.push((t, next(self._ctr), src, dst, tag, data, h))
            self.duplicated_cnt += 1
        h.delivered = True
        dead = (src in self.dead or dst in self.dead or
                (self._group is not None and
                 self._group.get(src, -1 - src) !=
                 self._group.get(dst, -1 - dst)))
        if self._digest is not None:
            self._digest.update(struct.pack(
                "<diiii", t, src, dst, tag, 0 if dead else 1))
            self._digest.update(data)
        if dead:
            h.failed = True
            self.dropped_cnt += 1
            return
        self.inboxes[dst].append((src, tag, data))
        self.delivered_cnt += 1
        self.last_dst = dst

    def advance(self, dt: float) -> None:
        """Advance virtual time by ``dt`` WITHOUT delivering anything
        — the explorer's "let timers fire while frames stay in
        flight" move (heartbeat timeouts, probe cadences). Frames
        already due keep their timestamps and deliver 'late', exactly
        like a congested link."""
        if dt < 0:
            raise ValueError("dt must be >= 0")
        self.now += dt


# ---------------------------------------------------------------------------
# Scenario harness: scripted chaos + property checks + seed replay
# ---------------------------------------------------------------------------

def merge_weather(script, weather):
    """``(script_arg, merged)`` for a scenario script and an optional
    weather profile: the caller's PRE-merge script, sorted (what
    replay recipes print — the recipe also prints the weather, whose
    steps re-merge at construction, so printing the merged script
    would double-apply them on replay), and the execution script with
    the weather's fault steps merged in. One definition shared by
    Scenario and FabricScenario so the two can never diverge."""
    script_arg = sorted(script, key=lambda s: s[0])
    if weather is not None:
        script = list(script) + list(
            getattr(weather, "script", ()) or ())
    return script_arg, sorted(script, key=lambda s: s[0])


def weather_hooks(weather):
    """``(delay_fn, drop_fn)`` from a weather profile, with any
    stateful sampler ``reset()`` first: a Gilbert chain reused across
    runs (two scenarios sharing one Weather, or run() called twice
    while debugging a violation) would otherwise start mid-burst and
    break the bit-for-bit replay-from-seed contract."""
    delay_fn = getattr(weather, "delay_fn", None)
    drop_fn = getattr(weather, "drop_fn", None)
    for fn in (delay_fn, drop_fn):
        reset = getattr(fn, "reset", None)
        if reset is not None:
            reset()
    return delay_fn, drop_fn


def pending_suffix(world) -> str:
    """The live in-flight state a SimViolation message carries next
    to the seed/replay recipe (None-safe: '' before the world
    exists)."""
    if world is None:
        return ""
    return (f"\npending events at failure: {world.pending_events()} "
            f"(vtime {world.now:.3f})")


class SimViolation(AssertionError):
    """A simulated run violated a protocol property. The message
    carries the seed and a one-line replay recipe."""


class Scenario:
    """One scripted, seeded, fully deterministic N-engine run.

    ``script`` is a list of ``(t, action, *args)`` steps applied when
    virtual time first reaches ``t``:

      ("partition", [[0,1],[2,3]]) | ("heal",) | ("kill", r) |
      ("restart", r) | ("bcast", r) | ("propose", r) |
      ("loss", p)  — set the iid drop rate from that point on

    Properties checked at the end of ``run()`` (violation => raises
    ``SimViolation`` with the seed):

      - exactly-once: no rank ever picked the same (origin, payload)
        broadcast twice;
      - termination: every proposal submitted by a rank alive at the
        end settled (COMPLETED or FAILED, never IN_PROGRESS);
      - convergence: every rank alive at the end holds the SAME
        membership view, exactly the live set, with no one stuck
        mid-rejoin;
      - delivery: every broadcast initiated by a continuously-alive
        rank OUTSIDE partition/kill windows reached every rank alive
        at the end (checked only when the script ends healed).
    """

    def __init__(self, world_size: int = 4, seed: int = 0,
                 duration: float = 240.0, script: Sequence = (),
                 drop_p: float = 0.0, dup_p: float = 0.0,
                 failure_timeout: float = 6.0,
                 heartbeat_interval: float = 1.0,
                 arq_rto: float = 1.5, arq_max_retries: int = 6,
                 op_deadline: Optional[float] = 60.0,
                 check_delivery: bool = True,
                 weather=None, scheduler: str = "heap",
                 telemetry: bool = False,
                 telemetry_interval: float = 2.0,
                 watchdog_rules: Optional[Sequence] = None,
                 incident_dir: Optional[str] = None):
        self.ws = world_size
        self.seed = seed
        self.duration = duration
        # in-band telemetry plane (docs/DESIGN.md §17): one
        # TelemetryPlane per engine, pumped in the drive loop — the
        # planes draw time only from the world clock, so instrumented
        # runs replay bit-for-bit like uninstrumented ones (digest
        # frames ARE part of the schedule, so the digests' presence is
        # itself replay-pinned); violation artifacts then include the
        # fleet view and the result carries the rollups
        self.telemetry = telemetry
        self.telemetry_interval = telemetry_interval
        # incident watchdog (docs/DESIGN.md §17): rides RANK 0's
        # telemetry plane (keep rank 0 alive — churn_script's
        # immortal= — for uninterrupted coverage); normalized to
        # grammar strings so the replay recipe reproduces the rules
        if watchdog_rules is not None and not telemetry:
            raise ValueError("watchdog_rules needs telemetry=True")
        if watchdog_rules is not None:
            from rlo_tpu_torch.observe import parse_rule
            watchdog_rules = [parse_rule(r).spec()
                              for r in watchdog_rules]
        self.watchdog_rules = watchdog_rules
        self.incident_dir = incident_dir
        # a weather profile (rlo_tpu_torch/workloads/weather.py) contributes
        # its scripted fault steps (churn kills/rejoins, loss windows)
        # plus the delay_fn/drop_fn hooks handed to the SimWorld; its
        # repr is part of the replay recipe
        self.weather = weather
        self.script_arg, self.script = merge_weather(script, weather)
        self.drop_p = drop_p
        self.dup_p = dup_p
        self.scheduler = scheduler
        self.engine_kw = dict(failure_timeout=failure_timeout,
                              heartbeat_interval=heartbeat_interval,
                              arq_rto=arq_rto,
                              arq_max_retries=arq_max_retries,
                              op_deadline=op_deadline)
        self.check_delivery = check_delivery

    def _replay_recipe(self) -> str:
        import inspect
        extra = ""
        # non-default engine knobs and property toggles are part of
        # the schedule: a recipe that omits them replays a DIFFERENT
        # scenario (the incident bundle's replay must be
        # self-contained). Defaults come from the __init__ signature
        # itself so this can never drift from it.
        params = inspect.signature(type(self).__init__).parameters
        for k in self.engine_kw:
            if self.engine_kw[k] != params[k].default:
                extra += f", {k}={self.engine_kw[k]!r}"
        if self.check_delivery != params["check_delivery"].default:
            extra += f", check_delivery={self.check_delivery!r}"
        if self.weather is not None:
            extra += f", weather={self.weather!r}"
        if self.scheduler != "heap":
            extra += f", scheduler={self.scheduler!r}"
        if self.telemetry:
            extra += (f", telemetry=True, telemetry_interval="
                      f"{self.telemetry_interval}")
        if self.watchdog_rules is not None:
            # incident_dir is deliberately omitted: trips replay
            # identically without writing bundles
            extra += f", watchdog_rules={self.watchdog_rules!r}"
        return (f"Scenario(world_size={self.ws}, seed={self.seed}, "
                f"duration={self.duration}, "
                f"script={self.script_arg!r}, "
                f"drop_p={self.drop_p}, dup_p={self.dup_p}"
                f"{extra}).run()")

    def _fail(self, why: str):
        art = self._dump_violation_artifacts(why)
        raise SimViolation(
            f"seed {self.seed}: {why}"
            f"{pending_suffix(getattr(self, '_world', None))}"
            f"\nreplay: {self._replay_recipe()}"
            + (f"\nper-rank metrics snapshot: {art}" if art else ""))

    def _dump_violation_artifacts(self, why: str) -> Optional[str]:
        """On a property violation, dump every live rank's engine
        ``metrics()`` snapshot (counters, queue depths, links, op
        latency, profiler phases) as JSON next to the replay recipe,
        so the perf/protocol state AT the failure is inspectable —
        not just reproducible. Directory from $RLO_SIM_ARTIFACTS
        (default: the system tempdir); best-effort, never masks the
        violation itself."""
        import json
        import os
        import tempfile

        engines = getattr(self, "_engines", None)
        world = getattr(self, "_world", None)
        if not engines:
            return None
        outdir = os.environ.get("RLO_SIM_ARTIFACTS") or \
            tempfile.gettempdir()
        path = os.path.join(
            outdir, f"rlo_sim_violation_seed{self.seed}.json")
        try:
            os.makedirs(outdir, exist_ok=True)
            with open(path, "w") as fh:
                json.dump({
                    "seed": self.seed,
                    "violation": why,
                    "replay": self._replay_recipe(),
                    "virtual_time": world.now if world else None,
                    "schedule_events": world.events if world else None,
                    "metrics": {str(e.rank): e.metrics()
                                for e in engines
                                if e.rank not in
                                (world.dead if world else ())},
                    # the fleet view at failure, when a telemetry
                    # plane was riding the run (docs/DESIGN.md §17)
                    "fleet_view": (next(
                        (p.view.snapshot(world.now if world else 0.0)
                         for r, p in sorted(
                             getattr(self, "_planes", {}).items())
                         if world is None or r not in world.dead),
                        None)),
                }, fh, indent=1)
        except OSError:
            return None
        return path

    def run(self) -> Dict:
        from rlo_tpu_torch.engine import (EngineManager, ProgressEngine,
                                          ReqState)
        from rlo_tpu_torch.wire import Tag

        delay_fn, drop_fn = weather_hooks(self.weather)
        world = SimWorld(self.ws, seed=self.seed, drop_p=self.drop_p,
                         dup_p=self.dup_p, scheduler=self.scheduler,
                         delay_fn=delay_fn, drop_fn=drop_fn)
        mgr = EngineManager()
        engines: List[ProgressEngine] = [
            ProgressEngine(world.transport(r), manager=mgr,
                           clock=world.clock, **self.engine_kw)
            for r in range(self.ws)]
        # exposed for the violation artifact dump (_fail)
        self._world, self._engines = world, engines
        planes = {}
        if self.telemetry:
            from rlo_tpu_torch.observe import TelemetryPlane
            # per-link accounting on: the digest's tx/rx/RTT extras
            # read the metrics registry — without this every fleet
            # view would show a fleet that apparently sent no frames
            for e in engines:
                e.enable_metrics()
            planes = {r: TelemetryPlane(
                engines[r], interval=self.telemetry_interval)
                for r in range(self.ws)}
        self._planes = planes
        self._watchdog = None
        if planes and self.watchdog_rules is not None:
            from rlo_tpu_torch.observe import Watchdog
            # engines passed by reference: restarts replace entries in
            # place, so bundles snapshot the CURRENT fleet
            self._watchdog = Watchdog(
                planes[0], self.watchdog_rules,
                incident_dir=self.incident_dir,
                replay=self._replay_recipe, engines=engines)
        incarnation = [0] * self.ws
        live = set(range(self.ws))
        ever_disturbed: set = set()   # ranks killed/restarted at any point
        delivered: Dict[int, List] = {r: [] for r in range(self.ws)}
        sent: List[Tuple[int, bytes, bool]] = []  # (origin, data, clean)
        proposals: List[Tuple[int, int]] = []
        bseq = itertools.count()
        partitioned = False
        ends_healed = True
        si = 0

        def clean() -> bool:
            return not partitioned

        while world.now < self.duration:
            while si < len(self.script) and \
                    self.script[si][0] <= world.now:
                step = self.script[si]
                si += 1
                act, args = step[1], step[2:]
                if act == "partition":
                    world.partition(args[0])
                    partitioned = True
                    ends_healed = False
                elif act == "heal":
                    world.heal()
                    partitioned = False
                    ends_healed = True
                elif act == "kill":
                    r = args[0]
                    world.kill_rank(r)
                    engines[r].cleanup()
                    live.discard(r)
                    ever_disturbed.add(r)
                elif act == "restart":
                    r = args[0]
                    if r in live:
                        continue
                    # exactly-once is per incarnation: the fresh life
                    # has no persisted pickup state, and the admission
                    # replay legitimately re-delivers recent traffic
                    # to it (that is the feature under test)
                    delivered[r] = []
                    world.restart_rank(r)
                    incarnation[r] += 1
                    engines[r] = ProgressEngine(
                        world.transport(r), manager=mgr,
                        clock=world.clock,
                        incarnation=incarnation[r], **self.engine_kw)
                    if planes:
                        # the restarted life gets a fresh plane (its
                        # digest seq space is incarnation-partitioned
                        # like the engine's broadcast seqs)
                        from rlo_tpu_torch.observe import TelemetryPlane
                        engines[r].enable_metrics()
                        planes[r] = TelemetryPlane(
                            engines[r],
                            interval=self.telemetry_interval)
                        if r == 0 and self._watchdog is not None:
                            # the watchdog follows rank 0's plane
                            # across restarts (trips/cooldowns
                            # survive; rate histories reset — the
                            # fresh view rebuilding is not a surge)
                            self._watchdog.rebind(planes[0])
                    live.add(r)
                elif act == "bcast":
                    r = args[0]
                    if r in live:
                        data = f"b{next(bseq)}r{r}".encode()
                        engines[r].bcast(data)
                        sent.append((r, data, clean()))
                elif act == "propose":
                    r = args[0]
                    if r in live and engines[r].my_own_proposal.state \
                            != ReqState.IN_PROGRESS:
                        pid = 100 + len(proposals)
                        engines[r].submit_proposal(
                            f"p{pid}".encode(), pid=pid)
                        proposals.append((r, pid))
                elif act == "loss":
                    world.drop_p = args[0]
                else:
                    raise ValueError(f"unknown script action {act!r}")
            world.step()
            mgr.progress_all()
            for r in list(live):
                if planes:
                    # the plane owns the pickup loop: digests are
                    # consumed, everything else comes back out
                    for m in planes[r].pump():
                        if m.type == int(Tag.BCAST):
                            delivered[r].append((m.origin, m.data))
                else:
                    e = engines[r]
                    while (m := e.pickup_next()) is not None:
                        if m.type == int(Tag.BCAST):
                            delivered[r].append((m.origin, m.data))

        # -- property checks ------------------------------------------
        for r in range(self.ws):
            if len(delivered[r]) != len(set(delivered[r])):
                dups = [d for d in delivered[r]
                        if delivered[r].count(d) > 1]
                self._fail(f"rank {r} picked up duplicates: "
                           f"{dups[:4]}")
        for r, pid in proposals:
            if r in live and engines[r].my_own_proposal.pid == pid and \
                    engines[r].my_own_proposal.state == \
                    ReqState.IN_PROGRESS:
                self._fail(f"rank {r} proposal pid={pid} never "
                           f"terminated")
        if ends_healed:
            views = {r: tuple(sorted(engines[r]._alive))
                     for r in live}
            want = tuple(sorted(live))
            for r, view in views.items():
                if view != want:
                    self._fail(f"membership diverged: rank {r} sees "
                               f"{view}, live set is {want} "
                               f"(all views: {views})")
                if engines[r]._awaiting_welcome:
                    self._fail(f"rank {r} stuck mid-rejoin")
            if self.check_delivery:
                undisturbed = live - ever_disturbed
                for origin, data, was_clean in sent:
                    if not was_clean or origin not in undisturbed:
                        continue
                    for r in sorted(undisturbed - {origin}):
                        if (origin, data) not in delivered[r]:
                            self._fail(
                                f"rank {r} never delivered {data!r} "
                                f"from rank {origin} (clean-window "
                                f"broadcast)")
        views = {r: tuple(sorted(engines[r]._alive)) for r in live}
        out = {
            "seed": self.seed,
            "digest": world.schedule_digest(),
            "events": world.events,
            "delivered": delivered,
            "views": views,
            "epochs": {r: engines[r].epoch for r in live},
            "rejoins": sum(engines[r].rejoins for r in live),
            "quarantined": sum(engines[r].epoch_quarantined
                               for r in live),
        }
        if planes and live:
            # the fleet as the lowest live rank's plane sees it —
            # the eventually-consistent view any rank can serve
            viewer = min(live)
            out["fleet_view"] = planes[viewer].view.snapshot(
                world.now, self_epoch=engines[viewer].epoch)
            out["telemetry"] = {r: planes[r].stats()
                                for r in sorted(live)}
        if self._watchdog is not None:
            out["incidents"] = [i.to_dict()
                                for i in self._watchdog.incidents]
        return out


# ---------------------------------------------------------------------------
# Canned scripts + the fixed-seed fuzz sweep (check.sh)
# ---------------------------------------------------------------------------

def make_scenario(kind: str, seed: int, world_size: int = 4):
    """One of the canned chaos shapes, deterministically derived from
    (kind, seed): 'partition' (split-brain + heal), 'restart' (kill +
    elastic rejoin), 'burst' (loss window), 'mixed' (all of it),
    'churn_weather' (sustained churn_script kills/rejoins under
    Gilbert burst loss, default watchdog SLOs armed — §18).
    Serving-fabric kinds ('fabric_kill', 'fabric_split',
    'fabric_rejoin' — docs/DESIGN.md §11) return a ``FabricScenario``
    with the same ``run()`` contract and property-violation
    behavior."""
    if kind in FABRIC_SCENARIO_KINDS:
        # lazy: serving imports the engine (and this module); the
        # plain protocol sweeps never pay for the fabric layer
        from rlo_tpu_torch.serving.scenario import make_fabric_scenario
        return make_fabric_scenario(kind, seed, world_size)
    # zlib.crc32, NOT hash(): str hashes are salted per process and
    # would make the derived script irreproducible across runs
    import zlib
    rng = Random((zlib.crc32(kind.encode()) & 0xffff) * 1_000_003 + seed)
    ws = world_size
    half = ws // 2
    traffic = [(2.0 + 3.0 * i, "bcast", rng.randrange(ws))
               for i in range(10)]
    if kind == "partition":
        cut = [list(range(half)), list(range(half, ws))]
        script = traffic + [
            (20.0, "partition", cut),
            (30.0, "bcast", 0),
            (75.0, "heal"),
            (150.0, "bcast", rng.randrange(ws)),
            (155.0, "propose", rng.randrange(ws)),
        ]
    elif kind == "restart":
        victim = rng.randrange(ws)
        script = traffic + [
            (20.0, "kill", victim),
            (24.0, "bcast", (victim + 1) % ws),
            (45.0, "restart", victim),
            (150.0, "bcast", rng.randrange(ws)),
            (155.0, "propose", (victim + 1) % ws),
        ]
    elif kind == "burst":
        script = traffic + [
            (15.0, "loss", 0.25),
            (16.0, "bcast", rng.randrange(ws)),
            (18.0, "propose", rng.randrange(ws)),
            (40.0, "loss", 0.0),
            (120.0, "bcast", rng.randrange(ws)),
        ]
    elif kind == "mixed":
        victim = rng.randrange(half, ws)
        cut = [list(range(half)), list(range(half, ws))]
        script = traffic + [
            (15.0, "loss", 0.05),
            (20.0, "partition", cut),
            (40.0, "kill", victim),
            (70.0, "heal"),
            (75.0, "loss", 0.0),
            (90.0, "restart", victim),
            (190.0, "bcast", 0),
            (195.0, "propose", 1),
        ]
    elif kind == "churn_weather":
        # sustained kill/rejoin churn UNDER correlated Gilbert burst
        # loss (docs/DESIGN.md §18): the healing-path stress shape —
        # epoch catch-up, batched admissions and the advert-scoped
        # re-flood all fire here. The default watchdog SLOs ride rank
        # 0's telemetry plane (churn_script immortal=) and any trip is
        # a sweep violation: churn at this rate is ORDINARY weather,
        # not an incident, once healing is cheap.
        from rlo_tpu_torch.workloads.weather import make_weather
        weather = make_weather(
            "churn", seed + 17, world_size=ws, rate=0.04,
            duration=170.0, start=12.0, mean_down=25.0,
            min_down=22.0, min_live=max(2, ws - 2), settle=70.0,
            immortal=(0,), max_kills=2,
            gilbert=dict(p_enter=0.01, p_exit=0.25, loss_bad=0.5))
        script = traffic + [
            (170.0, "bcast", rng.randrange(ws)),
            (175.0, "propose", 0),
        ]
        from rlo_tpu_torch.observe import DEFAULT_RULES
        return Scenario(world_size=ws, seed=seed, script=script,
                        duration=240.0, weather=weather,
                        telemetry=True,
                        watchdog_rules=list(DEFAULT_RULES),
                        check_delivery=False)
    else:
        raise ValueError(f"unknown scenario kind {kind!r}")
    # burst-loss windows make "every clean broadcast delivered
    # everywhere" unprovable mid-window; the dedup/termination/
    # convergence properties still hold
    return Scenario(world_size=ws, seed=seed, script=script,
                    duration=240.0,
                    check_delivery=(kind in ("partition", "restart")))


SCENARIO_KINDS = ("partition", "restart", "burst", "mixed",
                  "churn_weather")

#: serving-fabric scenario kinds (rlo_tpu_torch/serving/scenario.py); listed
#: here so the CLI sweep covers them without importing the serving
#: layer up front
FABRIC_SCENARIO_KINDS = ("fabric_kill", "fabric_split",
                         "fabric_rejoin", "fabric_paged",
                         "fabric_churn", "remedy_flap",
                         "remedy_hotspot", "remedy_split")

ALL_SCENARIO_KINDS = SCENARIO_KINDS + FABRIC_SCENARIO_KINDS


def fuzz_sweep(seeds: Sequence[int],
               kinds: Sequence[str] = SCENARIO_KINDS,
               world_size: int = 4, verbose: bool = False) -> Dict:
    """Run every (kind, seed) scenario; raises SimViolation (with the
    seed + replay recipe) on the first property violation."""
    total_rejoins = total_events = runs = 0
    for kind in kinds:
        for seed in seeds:
            res = make_scenario(kind, seed, world_size).run()
            if res.get("incidents"):
                names = sorted({i["name"] for i in res["incidents"]})
                raise SimViolation(
                    f"watchdog tripped under {kind!r}: {names} — the "
                    f"default SLOs must stay quiet under scripted "
                    f"weather; replay: make_scenario({kind!r}, "
                    f"{seed}, {world_size}).run()")
            runs += 1
            total_rejoins += res["rejoins"]
            total_events += res["events"]
            if verbose:
                print(f"  {kind} seed={seed}: events={res['events']} "
                      f"rejoins={res['rejoins']} "
                      f"digest={res['digest'][:12]}")
    return {"runs": runs, "rejoins": total_rejoins,
            "events": total_events}


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json
    import logging

    # the sweep deliberately drives hundreds of declarations/rejoins;
    # per-event warnings would swamp the check.sh output
    logging.getLogger("rlo_tpu_torch").setLevel(logging.ERROR)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, default=25,
                    help="seeds 0..N-1 per scenario kind")
    ap.add_argument("--kinds", default=",".join(ALL_SCENARIO_KINDS))
    ap.add_argument("--world-size", type=int, default=4)
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    res = fuzz_sweep(range(args.seeds), args.kinds.split(","),
                     args.world_size, verbose=args.verbose)
    print(json.dumps({"ok": True, **res}))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
