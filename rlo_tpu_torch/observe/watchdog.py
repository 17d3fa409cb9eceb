"""Incident watchdog: declarative SLO rules over the fleet view, and
self-contained incident bundles (docs/DESIGN.md §17).

The port's own copy of ``rlo_tpu/observe/watchdog.py``, line for line:
only the imports and the logger names differ, so both packages give the
same results and the same bytes for the same seed
(``tests/test_torch_observe.py`` holds them equal).

Rule grammar (one string per rule, or :class:`Rule` directly)::

    <name>: <agg>(<key>) [/ <window>s] <op> <threshold>

      agg    ::= sum | max          (fleet rollup to evaluate)
      key    ::= any wire.TELEM_KEYS member
      /Ns    ::= RATE mode: the rule watches the aggregate's growth
                 per virtual second over an N-second sliding window
                 (omitted = LEVEL mode: the aggregate itself)
      op     ::= >= | > | <= | <
      threshold ::= float

Examples — the four shapes the churn knee needs::

    retransmit-storm:      sum(arq_retransmits) / 10s >= 5.0
    epoch-lag-ceiling:     max(epoch_lag_max) >= 8
    rejoin-cascade:        sum(rejoins) / 30s >= 0.5
    pickup-backlog-growth: sum(pickup_backlog) / 10s >= 20.0

A tripped rule produces an :class:`Incident`; when the watchdog has an
``incident_dir`` it also writes a bundle: ``incident.json`` (rule,
observed value, virtual time, the seeded replay recipe, per-rank
``metrics()`` snapshots), ``fleet_view.json``, per-rank trace JSONL
dumps of the live TRACER, and the merged Chrome trace — exactly the
artifact set a rejoin-cascade post-mortem needs, emitted AT the trip
instead of reconstructed after. Time comes only from the plane's
engine clock, so trips are deterministic in the simulator (the
bundle's directory name is ``<rule>_<trip#>`` — replayable runs
produce identical names).
"""

from __future__ import annotations

import json
import os
import re
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

from rlo_tpu_torch.wire import TELEM_KEYS

_OPS = {
    ">=": lambda a, b: a >= b,
    ">": lambda a, b: a > b,
    "<=": lambda a, b: a <= b,
    "<": lambda a, b: a < b,
}

_RULE_RE = re.compile(
    r"^\s*(?P<name>[\w-]+)\s*:\s*(?P<agg>sum|max)\s*\(\s*"
    r"(?P<key>\w+)\s*\)\s*(?:/\s*(?P<win>[0-9.]+)\s*s)?\s*"
    r"(?P<op><=|>=|<|>)\s*(?P<thr>-?[0-9.]+)\s*$")


@dataclass
class Rule:
    """One declarative SLO rule (see the module grammar)."""
    name: str
    key: str
    threshold: float
    agg: str = "sum"          # "sum" | "max" fleet rollup
    mode: str = "level"       # "level" | "rate" (per vsec)
    window: float = 10.0      # rate-mode sliding window (vsec)
    op: str = ">="

    def __post_init__(self):
        if self.key not in TELEM_KEYS:
            raise ValueError(f"rule {self.name!r}: {self.key!r} is "
                             f"not a TELEM_KEYS member")
        if self.agg not in ("sum", "max"):
            raise ValueError(f"rule {self.name!r}: agg must be "
                             f"sum/max, got {self.agg!r}")
        if self.mode not in ("level", "rate"):
            raise ValueError(f"rule {self.name!r}: mode must be "
                             f"level/rate, got {self.mode!r}")
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: op must be one of "
                             f"{sorted(_OPS)}, got {self.op!r}")
        if self.mode == "rate" and self.window <= 0:
            raise ValueError(f"rule {self.name!r}: rate window must "
                             f"be positive")

    def spec(self) -> str:
        win = (f" / {self.window:g}s" if self.mode == "rate" else "")
        return (f"{self.name}: {self.agg}({self.key}){win} "
                f"{self.op} {self.threshold:g}")


def parse_rule(text: Union[str, Rule]) -> Rule:
    """Parse one grammar string into a :class:`Rule` (idempotent on
    Rule instances)."""
    if isinstance(text, Rule):
        return text
    m = _RULE_RE.match(text)
    if m is None:
        raise ValueError(f"unparseable watchdog rule {text!r} (want "
                         f"'<name>: <agg>(<key>) [/ Ns] <op> <thr>')")
    win = m.group("win")
    return Rule(name=m.group("name"), key=m.group("key"),
                threshold=float(m.group("thr")), agg=m.group("agg"),
                mode="rate" if win is not None else "level",
                window=float(win) if win is not None else 10.0,
                op=m.group("op"))


#: The default rule set — the four heal-cost SLOs ROADMAP item 4's
#: churn work steers by, at thresholds a healthy steady-state fleet
#: never crosses (tuned against the BENCH_sim churn legs).
DEFAULT_RULES = (
    "retransmit-storm: sum(arq_retransmits) / 10s >= 5.0",
    "epoch-lag-ceiling: max(epoch_lag_max) >= 8",
    "rejoin-cascade: sum(rejoins) / 30s >= 0.5",
    "pickup-backlog-growth: sum(pickup_backlog) / 10s >= 20.0",
)


@dataclass
class Incident:
    """One tripped rule: what fired, at what observed value, when, and
    where the bundle (if any) was written."""
    rule: Rule
    value: float
    vtime: float
    trip: int                     # per-rule trip ordinal (0, 1, ...)
    bundle_dir: Optional[str] = None

    def to_dict(self) -> Dict:
        return {"rule": self.rule.spec(), "name": self.rule.name,
                "key": self.rule.key, "agg": self.rule.agg,
                "mode": self.rule.mode, "window": self.rule.window,
                "op": self.rule.op, "threshold": self.rule.threshold,
                "value": self.value, "vtime": self.vtime,
                "trip": self.trip, "bundle_dir": self.bundle_dir}


@dataclass
class _RuleState:
    history: deque = field(default_factory=deque)  # (vtime, agg value)
    trips: int = 0
    next_ok: float = float("-inf")                 # cooldown gate
    forgave_at: float = float("-inf")              # last window reset


class Watchdog:
    """Evaluates SLO rules against a :class:`TelemetryPlane`'s fleet
    view and dumps incident bundles on trips.

    ``incident_dir``: bundle root (created on first trip); ``None``
    (and no ``$RLO_INCIDENT_DIR``) disables bundle writing — trips
    are still returned/recorded. Pass ``""`` to disable bundles
    explicitly even when ``$RLO_INCIDENT_DIR`` is set (a fleet
    harness with one watchdog per rank wants exactly one bundle
    writer, or every rank's trip 0 would overwrite the same
    ``<rule>_0/`` directory). ``cooldown`` (vsec) silences a rule
    after it trips so a sustained violation produces one incident per
    window, not one per pump. ``replay`` is the seeded replay recipe
    string (or a callable returning it) the bundle embeds — hand it
    the scenario/bench recipe so the incident replays from the
    bundle alone. ``engines`` (optional) adds per-rank ``metrics()``
    snapshots to the bundle.

    Attaching: ``Watchdog(plane, ...)`` registers itself as
    ``plane.watchdog``, so ``plane.pump()`` evaluates the rules once
    per emission interval, right after each digest goes out.

    ``forgive_keys``: rate-mode rules over these TELEM keys RESET
    their sliding window when the fleet's ``view_changes`` rollup
    bumps — a legitimate membership change (an admitted rejoin, a
    failure adoption) spends retransmits and rejoin work as its heal
    cost, and reading that spike as a storm would trip the very SLO
    whose remediation quarantines the healthy joiner. The reset is
    clear-then-append (the post-heal value becomes the new window
    baseline, absorbing the spike) and rate-limited to once per rule
    window: under a SUSTAINED flap the view changes more often than
    the window, and forgiving every bump would blind the rule to the
    cascade it exists to catch.
    """

    #: rate rules over these keys get view-change forgiveness — the
    #: two churn-cost counters whose heal spike is indistinguishable
    #: from the failure they watch for (see class docstring)
    FORGIVE_KEYS = ("arq_retransmits", "rejoins")

    def __init__(self, plane,
                 rules: Sequence[Union[str, Rule]] = DEFAULT_RULES, *,
                 incident_dir: Optional[str] = None,
                 cooldown: float = 60.0,
                 replay: Union[None, str, Callable[[], str]] = None,
                 engines: Optional[Sequence] = None,
                 forgive_keys: Optional[Sequence[str]] = None):
        self.plane = plane
        self.rules = [parse_rule(r) for r in rules]
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self.incident_dir = (incident_dir if incident_dir is not None
                             else os.environ.get("RLO_INCIDENT_DIR")
                             ) or None
        self.cooldown = cooldown
        self.replay = replay
        # kept by REFERENCE, snapshot at bundle time: harnesses that
        # replace engines in place on restart (Scenario) must see the
        # current fleet in the bundle, not the construction-time one
        self.engines = engines
        self.forgive_keys = frozenset(
            self.FORGIVE_KEYS if forgive_keys is None else forgive_keys)
        self.incidents: List[Incident] = []
        self.forgiveness = 0  # window resets granted (see FORGIVE_KEYS)
        self._state: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules}
        self._last_vc: Optional[int] = None
        plane.watchdog = self

    # ------------------------------------------------------------------
    def rebind(self, plane) -> None:
        """Follow a replacement plane (a restarted rank's fresh life).
        Rate histories are cleared: the new plane's FleetView starts
        empty and rebuilds from incoming digests, which a surviving
        sliding window would read as a fleet-wide counter surge — a
        false rate trip, not traffic. Trip counts and cooldowns
        survive (they are per-rule facts, not view state)."""
        self.plane = plane
        plane.watchdog = self
        for st in self._state.values():
            st.history.clear()
        self._last_vc = None

    def check(self) -> List[Incident]:
        """Evaluate every rule against the current fleet view; returns
        the NEWLY tripped incidents (also appended to
        ``self.incidents``)."""
        now = self.plane.clock()
        fired: List[Incident] = []
        # one rollup pass per aggregate per check — this runs once per
        # plane pump, i.e. on the simulator's drive loop (the sum
        # rollup is unconditional: the view-change forgiveness gate
        # reads it even when every sum rule is in cooldown)
        rollups = self.plane.view.rollups()
        rollup_max = None
        vc = rollups["view_changes"]
        vc_bumped = self._last_vc is not None and vc != self._last_vc
        self._last_vc = vc
        for rule in self.rules:
            st = self._state[rule.name]
            if rule.agg == "sum":
                value = float(rollups[rule.key])
            else:
                if rollup_max is None:
                    rollup_max = self.plane.view.rollup_max()
                value = float(rollup_max[rule.key])
            if rule.mode == "rate":
                hist = st.history
                if vc_bumped and rule.key in self.forgive_keys and \
                        now - st.forgave_at >= rule.window:
                    # a legitimate membership change: restart this
                    # rule's window so the heal spike becomes the new
                    # baseline instead of a rate trip — at most once
                    # per window, so a sustained flap (view changes
                    # faster than the window) still accumulates
                    hist.clear()
                    st.forgave_at = now
                    self.forgiveness += 1
                hist.append((now, value))
                while hist and hist[0][0] < now - rule.window:
                    hist.popleft()
                t0, v0 = hist[0]
                if now <= t0:
                    continue  # need two samples inside the window
                # Δ over the NOMINAL window, not the retained span: a
                # freshly (re)built history under-covers the window,
                # and dividing by the short span would read any burst
                # — e.g. the handful of adoptions around one ordinary
                # restart — as a fleet-wide storm
                value = (value - v0) / rule.window
            if now < st.next_ok:
                continue
            if _OPS[rule.op](value, rule.threshold):
                st.next_ok = now + self.cooldown
                inc = Incident(rule=rule, value=value, vtime=now,
                               trip=st.trips)
                st.trips += 1
                self._write_bundle(inc)
                self.incidents.append(inc)
                fired.append(inc)
        return fired

    # ------------------------------------------------------------------
    # bundle writing
    # ------------------------------------------------------------------
    def _replay_str(self) -> Optional[str]:
        if callable(self.replay):
            return self.replay()
        return self.replay

    def _write_bundle(self, inc: Incident) -> None:
        """Write the self-contained incident bundle (best-effort: an
        unwritable dir or an invalid trace records the trip without a
        bundle — the incident itself must never be masked by a
        bundle-writing failure)."""
        if self.incident_dir is None:
            return
        from rlo_tpu_torch.utils.timeline import (merge_timeline,
                                                  validate_chrome_trace)
        from rlo_tpu_torch.utils.tracing import TRACER
        d = os.path.join(self.incident_dir,
                         f"{inc.rule.name}_{inc.trip}")
        try:
            os.makedirs(d, exist_ok=True)
            view = self.plane.view.snapshot(
                self.plane.clock(), self_epoch=self.plane.engine.epoch)
            with open(os.path.join(d, "fleet_view.json"), "w") as f:
                json.dump(view, f, indent=1)
            doc = inc.to_dict()
            doc["bundle_dir"] = d
            doc["replay"] = self._replay_str()
            doc["rules"] = [r.spec() for r in self.rules]
            doc["plane"] = self.plane.stats()
            engines = (list(self.engines)
                       if self.engines is not None else [])
            if engines:
                doc["metrics"] = {
                    str(e.rank): e.metrics() for e in engines}
            # per-rank trace JSONL + the merged Chrome trace (empty
            # tracer => empty dumps; the merger tolerates them)
            paths = []
            for r in sorted({e.rank for e in engines}
                            or set(range(
                                self.plane.engine.world_size))):
                p = os.path.join(d, f"rank{r}.jsonl")
                TRACER.dump_jsonl(p, rank=r)
                paths.append(p)
            trace = merge_timeline(
                paths, out_path=os.path.join(d, "trace.json"))
            validate_chrome_trace(trace)
            doc["trace_events"] = trace["otherData"]["events"]
            # request-span dump (docs/DESIGN.md §19): every Ev.SPAN in
            # the ring, all ranks — rlo-trace consumes this directly,
            # so a tripped TTFT SLO ships the offending requests'
            # waterfalls inside the bundle
            from rlo_tpu_torch.utils.tracing import Ev
            span_events = TRACER.events(Ev.SPAN)
            with open(os.path.join(d, "spans.jsonl"), "w") as f:
                for ev in span_events:
                    f.write(json.dumps(ev.to_dict()) + "\n")
            doc["span_events"] = len(span_events)
            with open(os.path.join(d, "incident.json"), "w") as f:
                json.dump(doc, f, indent=1)
            inc.bundle_dir = d
        except (OSError, ValueError):
            # ValueError: validate_chrome_trace / merge_timeline on a
            # trace the schema check rejects
            inc.bundle_dir = None
