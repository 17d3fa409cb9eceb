"""Consensus-gated remediation: the control half of the fleet
telescope (docs/DESIGN.md §22).

The port's own copy of ``rlo_tpu/observe/remedy.py``, line for line:
only the imports and the logger names differ, so both packages give the
same results and the same bytes for the same seed
(``tests/test_torch_observe.py`` holds them equal).

The fleet had eyes (FleetView, the declarative-SLO watchdog) and
churn-proof healing, but a tripped SLO still had no hands:
a flapping rank kept receiving placements, a hot fleet kept admitting
at full rate, and the watchdog's only output was an incident bundle
on disk. This module closes the loop — and it closes it through the
paper's own IAR consensus, because a corrective action on shared
fleet state is exactly the thing a partitioned minority must never be
able to dual-execute. IAR is leaderless 2-phase commit (SURVEY.md):
any rank proposes, every rank judges against its OWN membership view,
votes AND-aggregate up the reverse broadcast tree, and the decision
reaches every member or none.

Three pieces:

  - **record vocabulary** — :class:`RemedyRecord`, four idempotent
    kinds riding the serving fabric's record framing (the kind byte
    values continue ``fabric.Rec``):

      * ``QUARANTINE target``    stop routing admits/placements to a
                                 rank (membership is untouched — the
                                 rank stays a member, keeps judging,
                                 keeps forwarding; it just stops
                                 OWNING work)
      * ``UNQUARANTINE target``  lift it (hysteresis-gated)
      * ``BACKPRESSURE level``   fleet-wide AIMD admission throttle
                                 (multiplicative-decrease level; the
                                 additive recovery is local, one level
                                 per clean window on the engine clock)
      * ``REBALANCE``            force a fresh placement round even
                                 when the record already names the
                                 right members (sheds laggard load)

    Records are ordered newest-wins by ``(version, proposer)`` per
    key-space (per-target for quarantine, fleet-wide for the others),
    so heal re-broadcasts and replayed decisions are idempotent.

  - **judges** — every rank vetoes a proposal that contradicts its
    membership view (a target it does not see as a member) or that
    breaches the blast-radius cap: never quarantine below the
    min-alive quorum (``max(2, world_size // 2 + 1)`` — a partitioned
    minority can NEVER satisfy it, which is the no-dual-act
    guarantee), never quarantine more than a configurable fraction of
    the fleet. The veto logic lives in ``DecodeFabric._judge_remedy``
    so proposer pre-flight and relay judgment share one predicate.

  - **:class:`RemedyPolicy`** — maps watchdog trips to proposed
    actions with hysteresis: trip → want; a want becomes a proposal
    only on the current proposer (the lowest non-quarantined member —
    one proposer avoids N identical concurrent rounds; any survivor
    takes over), retries while vetoable (e.g. the flapping target is
    mid-flap and not currently a member), and expires when its cause
    rule has been quiet for ``clear_window``. Un-quarantine fires
    only after EVERY rule has been quiet for a full ``clear_window``
    and the target is back in the membership view. Per-action
    cooldowns ride the engine clock, so the whole policy is
    R5-deterministic and replays bit-for-bit in the simulator.

Flapper identification is telemetry-native: digest seqs are
partitioned ``incarnation << 20`` (docs/DESIGN.md §17), so
``FleetView.incarnations()`` reads each rank's restart count straight
out of the last applied digest — a rank with incarnation >= 1 has
flapped at least once, and the highest-incarnation such rank is the
quarantine candidate.

Honest caveat (docs/DESIGN.md §22): under an ASYMMETRIC partition the
watchdogs on each side see different fleets, so both sides may WANT
contradictory actions — the quorum veto guarantees at most one side
can decide, but nobody remediates until the partition heals if no
side holds a min-alive quorum. Remediation is availability-biased
deliberately: a vetoed action costs nothing, an un-vetoed wrong
action costs a quarantined healthy rank — which the hysteresis then
un-quarantines.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

#: Remediation rounds use pid = REMEDY_PID_BASE + proposer rank — a
#: reserved window beside the placement window (FABRIC_PID_BASE + rank)
#: so concurrent placement and remedy rounds from different proposers
#: never collide. 1 << 10 of headroom bounds world_size; the fabric
#: asserts it.
REMEDY_PID_BASE = (1 << 20) + (1 << 10)  # FABRIC_PID_BASE + 1024

#: Record kind bytes — these CONTINUE the serving fabric's ``Rec``
#: enum (ADMIT=1 .. LOAD=4); fabric.Rec pins the same values and
#: tests/test_remedy.py asserts the two stay aligned. Defined here so
#: the policy layer never imports the fabric (the fabric imports us).
KIND_QUARANTINE = 5
KIND_UNQUARANTINE = 6
KIND_BACKPRESSURE = 7
KIND_REBALANCE = 8

REMEDY_KINDS = (KIND_QUARANTINE, KIND_UNQUARANTINE,
                KIND_BACKPRESSURE, KIND_REBALANCE)

KIND_NAMES = {
    KIND_QUARANTINE: "QUARANTINE",
    KIND_UNQUARANTINE: "UNQUARANTINE",
    KIND_BACKPRESSURE: "BACKPRESSURE",
    KIND_REBALANCE: "REBALANCE",
}


@dataclass(frozen=True)
class RemedyRecord:
    """One remediation record. ``target`` is the subject rank
    (quarantine kinds) or -1 (fleet-wide kinds); ``level`` is the
    AIMD backpressure level (BACKPRESSURE), the proposer's epoch
    (REBALANCE), or 0. ``(version, proposer)`` totally orders records
    within a key-space — versions come from
    ``DecodeFabric.next_remedy_version()`` (monotone past everything
    seen), proposer rank breaks exact ties — and execution is
    newest-wins, so a stale record re-flooded out of an old view can
    never regress the fleet's remediation state."""
    kind: int
    target: int
    level: int
    version: int
    proposer: int

    def key(self) -> Tuple[int, int]:
        return (self.version, self.proposer)

    def name(self) -> str:
        return KIND_NAMES.get(self.kind, f"kind{self.kind}")

    def encode(self) -> bytes:
        """Body bytes AFTER the fabric's magic + kind framing (the
        kind byte itself rides the frame, like every fabric record)."""
        return struct.pack("<iiii", self.target, self.level,
                           self.version, self.proposer)

    @classmethod
    def decode(cls, kind: int, raw: bytes,
               off: int = 0) -> Optional["RemedyRecord"]:
        if kind not in REMEDY_KINDS or len(raw) - off < 16:
            return None
        target, level, version, proposer = struct.unpack_from(
            "<iiii", raw, off)
        return cls(int(kind), target, level, version, proposer)


class _Want:
    """One desired-but-not-yet-decided action the policy is pursuing.
    ``next_try`` paces retries on the engine clock: a veto'd or
    slot-blocked want survives and retries; a decided or cause-cleared
    want is dropped."""
    __slots__ = ("kind", "target", "level", "cause", "next_try")

    def __init__(self, kind: int, target: int, level: int, cause: str):
        self.kind = kind
        self.target = target
        self.level = level
        self.cause = cause
        self.next_try = float("-inf")


#: rule name -> action shape. "quarantine_flapper" quarantines the
#: highest-incarnation restarted rank when one is identifiable and
#: falls back to BACKPRESSURE otherwise (a retransmit storm with no
#: flapper in sight is load, not a bad actor).
DEFAULT_ACTIONS = {
    "rejoin-cascade": "quarantine_flapper",
    "retransmit-storm": "quarantine_flapper",
    "pickup-backlog-growth": "backpressure",
    "epoch-lag-ceiling": "rebalance",
}


class RemedyPolicy:
    """Watchdog-trip -> IAR-proposal mapping with hysteresis (module
    docstring). Construct one per rank next to the rank's watchdog;
    ``fabric.pump()`` steps it once per turn (construction registers
    it as ``fabric.remedy``). Every rank tracks trips and wants —
    only the current proposer (lowest non-quarantined member)
    actually submits, so a proposer death hands the pending wants to
    the next survivor with no coordination.

    ``cooldown``: engine-clock seconds between proposals of the SAME
    action after one was submitted. ``retry``: pacing for wants that
    failed pre-flight (e.g. target mid-flap). ``clear_window``: how
    long a cause rule must stay quiet before its wants expire and —
    for every rule fleet-wide — before un-quarantine is proposed.
    ``bp_max`` caps the AIMD level (admission interval is
    ``bp_base * 2**(level-1)``, so the cap bounds the throttle at a
    known worst case)."""

    def __init__(self, fabric, watchdog, *,
                 cooldown: float = 12.0,
                 retry: float = 3.0,
                 clear_window: float = 35.0,
                 bp_max: int = 6,
                 actions: Optional[Dict[str, str]] = None):
        self.fabric = fabric
        self.watchdog = watchdog
        self.clock = fabric.clock
        self.cooldown = cooldown
        self.retry = retry
        self.clear_window = clear_window
        self.bp_max = bp_max
        self.actions = dict(DEFAULT_ACTIONS if actions is None
                            else actions)
        self._born = self.clock()
        self._inc_idx = 0
        self._last_trip: Dict[str, float] = {}
        self._wants: Dict[Tuple[int, int], _Want] = {}
        # decision log: (vtime, kind name, target, level, decided)
        self.log: List[Tuple[float, str, int, int, bool]] = []
        self.proposed = 0
        self.decided = 0
        self.rejected = 0
        fabric.remedy = self

    # ------------------------------------------------------------------
    # trip intake
    # ------------------------------------------------------------------
    def _consume_incidents(self, now: float) -> None:
        incs = self.watchdog.incidents
        for inc in incs[self._inc_idx:]:
            name = inc.rule.name
            self._last_trip[name] = inc.vtime
            shape = self.actions.get(name)
            if shape == "quarantine_flapper":
                target = self._flapper()
                if target is not None:
                    self._want(KIND_QUARANTINE, target, 0, name)
                else:
                    self._want(KIND_BACKPRESSURE, -1, 0, name)
            elif shape == "backpressure":
                self._want(KIND_BACKPRESSURE, -1, 0, name)
            elif shape == "rebalance":
                self._want(KIND_REBALANCE, -1, 0, name)
            # unmapped rules observe only (their trips still feed the
            # quiet clock that gates un-quarantine)
        self._inc_idx = len(incs)

    def _want(self, kind: int, target: int, level: int,
              cause: str) -> None:
        key = (kind, target)
        w = self._wants.get(key)
        if w is None:
            self._wants[key] = _Want(kind, target, level, cause)
        else:
            w.cause = cause  # refresh: the newest trip owns the want

    def _flapper(self) -> Optional[int]:
        """The quarantine candidate: the non-quarantined member with
        the highest telemetry incarnation >= 1 (lowest rank breaks
        ties) — the rank whose restarts the fleet has been paying
        for. None when no restarted rank is identifiable (then
        backpressure, not quarantine, is the honest action)."""
        plane = self.fabric.telemetry
        if plane is None:
            return None
        incarnations = plane.view.incarnations()
        best, best_inc = None, 0
        for r in sorted(incarnations):
            if r in self.fabric.quarantined or r == self.fabric.rank:
                continue
            inc = incarnations[r]
            if inc > best_inc:
                best, best_inc = r, inc
        return best

    # ------------------------------------------------------------------
    # the step (called from fabric.pump, once per turn)
    # ------------------------------------------------------------------
    def step(self) -> None:
        now = self.clock()
        self._consume_incidents(now)
        self._expire_wants(now)
        self._want_unquarantine(now)
        fab = self.fabric
        group = set(fab.engine.group)
        cands = sorted(group - fab.quarantined) or sorted(group)
        if fab.rank != cands[0]:
            return  # not the proposer: track state, submit nothing
        for key in sorted(self._wants):
            w = self._wants[key]
            if now < w.next_try:
                continue
            rec = self._build(w, now)
            if rec is None or fab._judge_remedy(rec) != 1:
                # pre-flight veto (target mid-flap, quorum/blast cap,
                # already satisfied): keep the want, retry soon
                w.next_try = now + self.retry
                continue
            if fab.propose_remedy(rec):
                self.proposed += 1
                w.next_try = now + self.cooldown
            # slot busy (a placement or earlier remedy round is in
            # flight): leave next_try, retry next pump
            break  # one proposal slot; at most one submit per step

    def _build(self, w: _Want, now: float) -> Optional[RemedyRecord]:
        fab = self.fabric
        if w.kind == KIND_QUARANTINE and \
                w.target in fab.quarantined:
            return None  # already satisfied; _expire_wants drops it
        level = w.level
        if w.kind == KIND_BACKPRESSURE:
            level = min(self.bp_max, fab.bp_level + 1)
            if level <= fab.bp_level:
                return None  # capped out: nothing stronger to ask for
        elif w.kind == KIND_REBALANCE:
            level = fab.engine.epoch
        return RemedyRecord(kind=w.kind, target=w.target, level=level,
                            version=fab.next_remedy_version(),
                            proposer=fab.rank)

    def _expire_wants(self, now: float) -> None:
        drop = []
        for key, w in self._wants.items():
            satisfied = (
                (w.kind == KIND_QUARANTINE and
                 w.target in self.fabric.quarantined) or
                (w.kind == KIND_UNQUARANTINE and
                 w.target not in self.fabric.quarantined))
            cause_quiet = (now - self._last_trip.get(w.cause,
                                                     self._born)
                           >= self.clear_window)
            if satisfied or (w.kind != KIND_UNQUARANTINE and
                             cause_quiet):
                drop.append(key)
        for key in drop:
            del self._wants[key]

    def _want_unquarantine(self, now: float) -> None:
        """Hysteresis: lift a quarantine only after EVERY rule has
        been quiet for a full clear_window (the clearing SLO held)
        and the target is back in the membership view (lifting a
        dead rank's quarantine would just re-arm the flap)."""
        fab = self.fabric
        if not fab.quarantined:
            return
        last = max(self._last_trip.values(), default=self._born)
        if now - max(last, self._born) < self.clear_window:
            return
        for target in sorted(fab.quarantined):
            if target in fab.engine.group:
                self._want(KIND_UNQUARANTINE, target, 0, "clear")

    # ------------------------------------------------------------------
    # proposer-side outcome (fabric calls this when its own round ends)
    # ------------------------------------------------------------------
    def on_outcome(self, rec: RemedyRecord, decided: bool) -> None:
        self.log.append((self.clock(), rec.name(), rec.target,
                         rec.level, decided))
        if decided:
            self.decided += 1
            self._wants.pop((rec.kind, rec.target), None)
        else:
            self.rejected += 1

    def stats(self) -> Dict:
        return {
            "proposed": self.proposed,
            "decided": self.decided,
            "rejected": self.rejected,
            "wants": sorted((KIND_NAMES.get(k, str(k)), t)
                            for k, t in self._wants),
            "log": list(self.log),
        }
