"""Scripted serving-fabric scenarios over the deterministic simulator.

The port's own copy of ``rlo_tpu/serving/scenario.py``, line for line:
only the imports and the logger names differ, so both packages give the
same results and the same bytes for the same seed
(``tests/test_torch_fabric.py`` holds them equal).

The fabric twin of ``transport.sim.Scenario`` (docs/DESIGN.md §8/§11):
N engines + N ``DecodeFabric`` nodes (stub backend) run over one
seeded ``SimWorld``; a script injects client traffic and faults at
virtual times; end-of-run property checks raise ``SimViolation`` with
the seed and a replay recipe. Same seed => byte-identical schedule =>
identical request ids, owners, completions, and tokens.

Script steps (``(t, action, *args)``):

  ("submit", gateway, n)    — n client requests through that gateway
  ("kill", r) / ("restart", r) / ("partition", groups) / ("heal",) /
  ("loss", p)               — the Scenario fault vocabulary

Properties checked at the end of ``run()`` (runs that end healed):

  - **drained**: every request a live fabric knows is completed there
    (no accepted request hangs);
  - **exactly-once**: no live fabric's client-visible completion log
    contains a rid twice;
  - **identical tokens**: every completion equals the stub model's
    oracle (``backend.stub_tokens``) — the re-queued, re-decoded,
    re-admitted copies all produced the same tokens;
  - **acceptance**: every request submitted through a never-disturbed
    gateway outside partition windows is known and completed at every
    live fabric (the fabric analogue of the clean-broadcast delivery
    check);
  - **placement convergence**: every live fabric holds the SAME
    placement record, spanning exactly the live set.
"""

from __future__ import annotations

from random import Random
from typing import Dict, List, Optional, Sequence

from rlo_tpu_torch.observe.spans import SpanRecorder
from rlo_tpu_torch.serving.backend import StubBackend, stub_tokens
from rlo_tpu_torch.serving.fabric import DecodeFabric
from rlo_tpu_torch.utils.tracing import Tracer
from rlo_tpu_torch.transport.sim import \
    FABRIC_SCENARIO_KINDS as _FABRIC_SCENARIO_KINDS
from rlo_tpu_torch.transport.sim import (SimViolation, SimWorld,
                                         merge_weather, pending_suffix,
                                         weather_hooks)

#: default engine knobs for fabric runs: the Scenario defaults with a
#: tighter op deadline so a placement round wedged across a view
#: change fails-and-retries quickly instead of parking the
#: own-proposal slot for a minute of virtual time
FABRIC_ENGINE_KW = dict(failure_timeout=6.0, heartbeat_interval=1.0,
                        arq_rto=1.5, arq_max_retries=6,
                        op_deadline=20.0)


class FabricScenario:
    """One scripted, seeded, fully deterministic N-node fabric run."""

    def __init__(self, world_size: int = 4, seed: int = 0,
                 duration: float = 240.0, script: Sequence = (),
                 drop_p: float = 0.0, dup_p: float = 0.0,
                 n_slots: int = 2, round_len: int = 8,
                 decode_interval: float = 0.25,
                 engine_kw: Optional[dict] = None,
                 check_acceptance: bool = True,
                 paged_stub: bool = False, n_pages: int = 33,
                 page_size: int = 8,
                 prefix_pool: Optional[Sequence[Sequence[int]]] = None,
                 weather=None, scheduler: str = "heap",
                 trace_sample: Optional[int] = None,
                 telemetry: bool = False,
                 telemetry_interval: float = 1.0,
                 watchdog_rules: Optional[Sequence] = None,
                 watchdog_cooldown: float = 60.0,
                 remedy: bool = False,
                 remedy_kw: Optional[dict] = None,
                 expect_quarantine: Optional[int] = None,
                 expect_backpressure: bool = False,
                 expect_recovered: bool = True):
        self.ws = world_size
        self.seed = seed
        self.duration = duration
        # weather profile (rlo_tpu_torch/workloads/weather.py): scripted
        # churn/loss steps merged into the script, delay_fn/drop_fn
        # handed to the SimWorld — contract and bookkeeping shared
        # with Scenario via transport.sim.merge_weather/weather_hooks
        self.weather = weather
        self.scheduler = scheduler
        self.script_arg, self.script = merge_weather(script, weather)
        self.drop_p = drop_p
        self.dup_p = dup_p
        self.n_slots = n_slots
        self.round_len = round_len
        # vtime per decode round: scripts that must catch requests
        # MID-decode (kill/partition with work in flight) stretch this
        # so budgets span several seconds of virtual time
        self.decode_interval = decode_interval
        self.engine_kw = dict(FABRIC_ENGINE_KW if engine_kw is None
                              else engine_kw)
        self.check_acceptance = check_acceptance
        # paged serving twin (docs/DESIGN.md §12): back every node
        # with PagedStubBackend so allocator churn / COW / eviction /
        # backpressure run under fabric chaos; ``prefix_pool`` makes
        # submitted prompts share leading chunks (radix-reuse traffic)
        self.paged_stub = paged_stub
        self.n_pages = n_pages
        self.page_size = page_size
        self.prefix_pool = (None if prefix_pool is None else
                            [tuple(p) for p in prefix_pool])
        # rlo-trace (docs/DESIGN.md §19): trace_sample=1/N attaches a
        # SpanRecorder per rank (shared seed => every rank samples the
        # same rid set) emitting into ``self.tracer`` — a private ring,
        # so the process-wide TRACER's enabled state is untouched.
        # None (the default) runs the zero-cost disabled path.
        self.trace_sample = trace_sample
        self.tracer: Optional[Tracer] = None
        # remediation control plane (docs/DESIGN.md §22): telemetry
        # arms a per-rank TelemetryPlane + Watchdog (bundles off —
        # trips are data here, not artifacts); remedy additionally
        # attaches a RemedyPolicy per rank, so watchdog trips become
        # IAR-decided QUARANTINE/BACKPRESSURE/REBALANCE records, and
        # the end-of-run checks assert the §22 invariants (quarantine
        # agreement, min-alive floor, blast cap, recovery)
        self.telemetry = telemetry or remedy
        self.telemetry_interval = telemetry_interval
        self.watchdog_rules = (None if watchdog_rules is None
                               else list(watchdog_rules))
        self.watchdog_cooldown = watchdog_cooldown
        self.remedy = remedy
        self.remedy_kw = dict(remedy_kw or {})
        self.expect_quarantine = expect_quarantine
        self.expect_backpressure = expect_backpressure
        self.expect_recovered = expect_recovered

    def _replay_recipe(self) -> str:
        # every non-default knob is printed: a recipe that silently
        # falls back to default slots/round/decode pacing (or drops
        # the paged-stub config) replays a DIFFERENT schedule than
        # the one that violated
        extra = ""
        for name, val, default in (
                ("n_slots", self.n_slots, 2),
                ("round_len", self.round_len, 8),
                ("decode_interval", self.decode_interval, 0.25),
                ("engine_kw", self.engine_kw, dict(FABRIC_ENGINE_KW)),
                ("check_acceptance", self.check_acceptance, True),
                ("paged_stub", self.paged_stub, False),
                ("n_pages", self.n_pages, 33),
                ("page_size", self.page_size, 8),
                ("prefix_pool", self.prefix_pool, None),
                ("weather", self.weather, None),
                ("scheduler", self.scheduler, "heap"),
                ("trace_sample", self.trace_sample, None),
                ("telemetry", self.telemetry, False),
                ("telemetry_interval", self.telemetry_interval, 1.0),
                ("watchdog_rules", self.watchdog_rules, None),
                ("watchdog_cooldown", self.watchdog_cooldown, 60.0),
                ("remedy", self.remedy, False),
                ("remedy_kw", self.remedy_kw, {}),
                ("expect_quarantine", self.expect_quarantine, None),
                ("expect_backpressure", self.expect_backpressure,
                 False),
                ("expect_recovered", self.expect_recovered, True)):
            if val != default:
                extra += f", {name}={val!r}"
        return (f"FabricScenario(world_size={self.ws}, "
                f"seed={self.seed}, duration={self.duration}, "
                f"script={self.script_arg!r}, drop_p={self.drop_p}, "
                f"dup_p={self.dup_p}{extra}).run()")

    def _fail(self, why: str):
        raise SimViolation(
            f"seed {self.seed}: {why}"
            f"{pending_suffix(getattr(self, '_world', None))}"
            f"\nreplay: {self._replay_recipe()}")

    def run(self) -> Dict:
        from rlo_tpu_torch.engine import EngineManager, ProgressEngine

        delay_fn, drop_fn = weather_hooks(self.weather)
        world = SimWorld(self.ws, seed=self.seed, drop_p=self.drop_p,
                         dup_p=self.dup_p, scheduler=self.scheduler,
                         delay_fn=delay_fn, drop_fn=drop_fn)
        # exposed for the violation message (pending_events + vtime)
        self._world = world
        mgr = EngineManager()
        engines: List[ProgressEngine] = [
            ProgressEngine(world.transport(r), manager=mgr,
                           clock=world.clock, **self.engine_kw)
            for r in range(self.ws)]
        def make_backend():
            if self.paged_stub:
                from rlo_tpu_torch.serving.backend import PagedStubBackend
                return PagedStubBackend(n_slots=self.n_slots,
                                        round_len=self.round_len,
                                        n_pages=self.n_pages,
                                        page_size=self.page_size)
            return StubBackend(n_slots=self.n_slots,
                               round_len=self.round_len)

        # span recorders persist across a rank's restarts (the rid
        # sample set and the ring are properties of the RUN, not of
        # one engine incarnation)
        recorders: List[Optional[SpanRecorder]] = [None] * self.ws
        if self.trace_sample is not None:
            self.tracer = Tracer(capacity=1 << 20, enabled=True)
            recorders = [
                SpanRecorder(r, world.clock,
                             sample=self.trace_sample,
                             seed=self.seed, tracer=self.tracer)
                for r in range(self.ws)]

        def make_fabric(r: int) -> DecodeFabric:
            fab = DecodeFabric(
                engines[r], make_backend(),
                decode_interval=self.decode_interval,
                spans=recorders[r])
            if self.telemetry:
                # per-rank observe stack, rebuilt with the fabric on
                # restart (a fresh life has a fresh view — §17);
                # incident_dir="" keeps N watchdogs from racing over
                # one bundle directory (trips are data here)
                from rlo_tpu_torch.observe import (DEFAULT_RULES,
                                                   RemedyPolicy,
                                                   TelemetryPlane, Watchdog)
                plane = TelemetryPlane(
                    engines[r], interval=self.telemetry_interval)
                fab.attach_telemetry(plane)
                wd = Watchdog(
                    plane,
                    (DEFAULT_RULES if self.watchdog_rules is None
                     else self.watchdog_rules),
                    incident_dir="",
                    cooldown=self.watchdog_cooldown,
                    replay=self._replay_recipe)
                if self.remedy:
                    RemedyPolicy(fab, wd, **self.remedy_kw)
            return fab

        fabrics: List[DecodeFabric] = [make_fabric(r)
                                       for r in range(self.ws)]
        rng = Random(self.seed * 1_000_003 + 17)
        incarnation = [0] * self.ws
        live = set(range(self.ws))
        ever_disturbed: set = set()
        partitioned = False
        ends_healed = True
        #: rid -> (prompt, max_new, clean) for every client submission
        submitted: Dict = {}
        si = 0

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
                    world.restart_rank(r)
                    incarnation[r] += 1
                    engines[r] = ProgressEngine(
                        world.transport(r), manager=mgr,
                        clock=world.clock,
                        incarnation=incarnation[r], **self.engine_kw)
                    fabrics[r] = make_fabric(r)
                    live.add(r)
                elif act == "submit":
                    g, n = args[0], args[1]
                    if g not in live:
                        continue
                    for _ in range(n):
                        plen = rng.randrange(3, 10)
                        prompt = tuple(rng.randrange(1, 1 << 15)
                                       for _ in range(plen))
                        if self.prefix_pool is not None:
                            prompt = (self.prefix_pool[rng.randrange(
                                len(self.prefix_pool))] + prompt)
                        max_new = rng.randrange(4, 24)
                        rid = fabrics[g].submit(prompt, max_new)
                        clean = (not partitioned and
                                 g not in ever_disturbed)
                        submitted[rid] = (prompt, max_new, clean)
                elif act == "loss":
                    world.drop_p = args[0]
                else:
                    raise ValueError(f"unknown script action {act!r}")
            world.step()
            mgr.progress_all()
            for r in sorted(live):
                fabrics[r].pump()

        # -- property checks ------------------------------------------
        live_fabrics = [fabrics[r] for r in sorted(live)]
        for f in live_fabrics:
            if len(f.completions) != len(set(f.completions)):
                dups = [c for c in f.completions
                        if f.completions.count(c) > 1]
                self._fail(f"rank {f.rank} delivered duplicate "
                           f"completions: {sorted(set(dups))[:4]}")
        if ends_healed:
            for f in live_fabrics:
                hung = [rid for rid in f.requests
                        if rid not in f.done]
                if hung:
                    self._fail(f"rank {f.rank} holds accepted "
                               f"requests that never completed: "
                               f"{hung[:4]}")
            for f in live_fabrics:
                for rid, toks in f.done.items():
                    info = submitted.get(rid)
                    if info is None:
                        continue  # a restarted life's re-admission
                    want = stub_tokens(info[0], info[1])
                    if tuple(toks) != want:
                        self._fail(
                            f"rank {f.rank} completion for {rid} "
                            f"diverged from the oracle: got "
                            f"{toks[:6]}..., want {want[:6]}...")
            if self.check_acceptance:
                undisturbed = live - ever_disturbed
                for rid, (_, _, clean) in submitted.items():
                    if not clean or rid[0] not in undisturbed:
                        continue
                    for f in live_fabrics:
                        if rid not in f.done:
                            self._fail(
                                f"rank {f.rank} never completed "
                                f"clean-window request {rid} "
                                f"(gateway {rid[0]})")
            if self.paged_stub:
                # page-leak check: with every request drained, the
                # only live references are the trie's own (one per
                # registered entry) — anything else is a leaked
                # request/COW reservation
                for f in live_fabrics:
                    be = f.backend
                    if be.alloc.pages_in_use != be.trie.entries:
                        self._fail(
                            f"rank {f.rank} leaked pages: "
                            f"{be.alloc.pages_in_use} in use vs "
                            f"{be.trie.entries} trie entries "
                            f"({be.alloc.stats()})")
            places = {f.rank: (f.placement.key(),
                               tuple(f.placement.members))
                      for f in live_fabrics}
            want_members = tuple(sorted(live))
            first = next(iter(places.values()))
            for r, pl in places.items():
                if pl != first or pl[1] != want_members:
                    self._fail(f"placement diverged: {places} "
                               f"(live {want_members})")
        if self.remedy:
            self._check_remedy(live_fabrics, ends_healed)
        return {
            "seed": self.seed,
            "digest": world.schedule_digest(),
            "events": world.events,
            "submitted": len(submitted),
            "completed": {f.rank: len(f.completions)
                          for f in live_fabrics},
            "done_tokens": {f.rank: dict(f.done)
                            for f in live_fabrics},
            "requeues": sum(f.requeues for f in live_fabrics),
            "dup_done": sum(f.dup_done for f in live_fabrics),
            "readmitted": sum(
                f.metrics.counter("fabric.readmitted").value
                for f in live_fabrics),
            "rejoins": sum(engines[r].rejoins for r in live),
            "placement_version": max(
                (f.placement.version for f in live_fabrics),
                default=-1),
            # NOTE: remedy evidence lives under "remedy", never under
            # an "incidents" key — fuzz_sweep treats res["incidents"]
            # as an unexpected-trip failure, and remedy runs TRIP by
            # design
            "remedy": (None if not self.remedy else {
                "decided": sum(f.remedy.decided for f in live_fabrics
                               if f.remedy is not None),
                "proposed": sum(f.remedy.proposed
                                for f in live_fabrics
                                if f.remedy is not None),
                "rejected": sum(f.remedy.rejected
                                for f in live_fabrics
                                if f.remedy is not None),
                "trips": sum(
                    len(f.telemetry.watchdog.incidents)
                    for f in live_fabrics
                    if f.telemetry is not None and
                    f.telemetry.watchdog is not None),
                "final_quarantined": sorted(
                    set().union(*(f.quarantined
                                  for f in live_fabrics))
                    if live_fabrics else set()),
                "bp_final": max((f.bp_level for f in live_fabrics),
                                default=0),
                "logs": {f.rank: list(f.remedy_log)
                         for f in live_fabrics},
                # the proposer's decision log — what the seed-replay
                # test pins alongside the schedule digest
                "decision_log": (live_fabrics[0].remedy.log
                                 if live_fabrics and
                                 live_fabrics[0].remedy is not None
                                 else []),
            }),
        }

    def _check_remedy(self, live_fabrics, ends_healed: bool) -> None:
        """The §22 remediation invariants, property-checked on every
        remedy-armed run (SimViolation + replay recipe on failure —
        same contract as the §11 fabric properties)."""
        for f in live_fabrics:
            for entry in f.remedy_log:
                _, name, target, _, group_size, quar_after = entry
                if name not in ("QUARANTINE", "UNQUARANTINE"):
                    continue
                if group_size - quar_after < f.remedy_min_alive:
                    self._fail(
                        f"rank {f.rank} executed {name} of {target} "
                        f"leaving {group_size - quar_after} live "
                        f"non-quarantined members — below the "
                        f"min-alive quorum {f.remedy_min_alive} "
                        f"({entry})")
                cap = max(1, int(f.remedy_blast_frac * group_size))
                if name == "QUARANTINE" and quar_after > cap:
                    self._fail(
                        f"rank {f.rank} executed {name} of {target} "
                        f"breaching the blast-radius cap {cap} "
                        f"({entry})")
        if not ends_healed:
            return
        # no dual-act: the agreed quarantine state is identical at
        # every live member once the run ends healed
        quar_sets = {f.rank: tuple(sorted(f.quarantined))
                     for f in live_fabrics}
        if len(set(quar_sets.values())) > 1:
            self._fail(f"quarantine state diverged across the fleet: "
                       f"{quar_sets}")
        all_logs = [e for f in live_fabrics for e in f.remedy_log]
        if self.expect_quarantine is not None:
            hits = [e for e in all_logs
                    if e[1] == "QUARANTINE" and
                    e[2] == self.expect_quarantine]
            if not hits:
                self._fail(
                    f"expected rank {self.expect_quarantine} to be "
                    f"quarantined; remedy logs: "
                    f"{sorted(set((e[1], e[2]) for e in all_logs))}")
            decided = sum(f.remedy.decided for f in live_fabrics
                          if f.remedy is not None)
            if decided < 1:
                self._fail("quarantine executed without any "
                           "IAR-decided remedy round")
        if self.expect_backpressure:
            hits = [e for e in all_logs
                    if e[1] == "BACKPRESSURE" and e[3] >= 1]
            if not hits:
                self._fail(
                    f"expected an IAR-decided BACKPRESSURE level >= "
                    f"1; remedy logs: "
                    f"{sorted(set((e[1], e[3]) for e in all_logs))}")
        if self.expect_recovered:
            for f in live_fabrics:
                if f.quarantined:
                    self._fail(
                        f"rank {f.rank} still quarantines "
                        f"{sorted(f.quarantined)} at end of run — "
                        f"the un-quarantine hysteresis never lifted "
                        f"it after the fault cleared")
                if f.bp_level != 0:
                    self._fail(
                        f"rank {f.rank} admission backpressure never "
                        f"recovered (level {f.bp_level} at end)")
                if f._admit_queue:
                    self._fail(
                        f"rank {f.rank} still holds "
                        f"{len(f._admit_queue)} throttled admits at "
                        f"end of run")


def make_fabric_scenario(kind: str, seed: int,
                         world_size: int = 4) -> FabricScenario:
    """Canned fabric chaos shapes, deterministically derived from
    (kind, seed) — the serving rows of ``transport.sim.make_scenario``:

      - 'fabric_kill':   client bursts, then a serving rank is killed
        mid-decode; survivors re-queue its orphans exactly once;
      - 'fabric_split':  a split-brain lands in the middle of a
        request burst; both sides keep serving, the minority's
        accepted requests are re-admitted after the heal without
        duplication;
      - 'fabric_rejoin': kill + elastic rejoin under continuous load;
        the rejoined rank converges and takes ownership back.
      - 'fabric_paged':  the fabric_kill shape over PagedStubBackend
        nodes with a TIGHT page pool and a shared-prefix prompt mix —
        allocator churn, radix reuse, COW, eviction and admission
        backpressure all run under fail-over, and the end-of-run
        page-leak check proves re-queues never strand a reservation.
      - 'fabric_churn':  sustained churn RATE, not one scripted kill:
        a seeded weather profile (workloads/weather.py churn_script,
        exponential kill/rejoin interarrivals) runs under continuous
        client load — placement re-forms repeatedly, every accepted
        request still completes exactly once and the fleet ends
        converged (docs/DESIGN.md §14).
    """
    import zlib
    rng = Random((zlib.crc32(kind.encode()) & 0xffff) * 1_000_003
                 + seed)
    ws = world_size
    half = ws // 2
    if kind == "fabric_kill":
        # rank 0 is the default least-loaded owner while the load
        # gossip warms up, so killing it right after a burst reliably
        # orphans IN-FLIGHT decodes (the re-queue path under test);
        # the slow decode_interval keeps budgets spanning the kill
        victim = 0
        gw = 1 + rng.randrange(ws - 1)
        script = (
            [(2.0 + 1.5 * i, "submit", rng.randrange(ws), 2)
             for i in range(4)] +
            [(10.0, "submit", gw, 3),
             (12.0, "kill", victim),
             (14.0, "submit", gw, 2),
             (40.0, "submit", 1 + rng.randrange(ws - 1), 2)])
        return FabricScenario(world_size=ws, seed=seed, script=script,
                              duration=150.0, decode_interval=1.0)
    if kind == "fabric_split":
        cut = [list(range(half)), list(range(half, ws))]
        script = (
            [(2.0 + 1.0 * i, "submit", rng.randrange(ws), 2)
             for i in range(6)] +
            [(10.0, "partition", cut),
             (12.0, "submit", rng.randrange(half), 2),
             (13.0, "submit", half + rng.randrange(ws - half), 2),
             # late-minority burst: still decoding when the heal
             # lands, so the re-admission path (pending ADMITs
             # re-broadcast on view growth) is actually exercised
             (57.0, "submit", half + rng.randrange(ws - half), 2),
             (60.0, "heal"),
             (150.0, "submit", rng.randrange(ws), 2)])
        return FabricScenario(world_size=ws, seed=seed, script=script,
                              duration=240.0, decode_interval=1.0,
                              round_len=4)
    if kind == "fabric_paged":
        victim = 0  # see fabric_kill: the warm-up owner
        gw = 1 + rng.randrange(ws - 1)
        # two shared system prefixes spanning 1-2 full 8-token pages
        prefixes = [tuple(rng.randrange(1, 1 << 15)
                          for _ in range(8 * (1 + i % 2)))
                    for i in range(2)]
        script = (
            [(2.0 + 1.5 * i, "submit", rng.randrange(ws), 2)
             for i in range(5)] +
            [(10.0, "submit", gw, 3),
             (12.0, "kill", victim),
             (14.0, "submit", gw, 3),
             (40.0, "submit", 1 + rng.randrange(ws - 1), 2)])
        return FabricScenario(world_size=ws, seed=seed, script=script,
                              duration=150.0, decode_interval=1.0,
                              paged_stub=True, n_pages=17,
                              page_size=8, prefix_pool=prefixes)
    if kind == "fabric_churn":
        # the weather profile owns every fault; the script is pure
        # client load spread across the churn window
        from rlo_tpu_torch.workloads.weather import make_weather
        weather = make_weather("churn", seed, world_size=ws,
                               rate=0.04, duration=240.0,
                               mean_down=20.0,
                               min_live=max(2, ws - 2), settle=80.0)
        script = (
            [(2.0 + 2.5 * i, "submit", rng.randrange(ws), 2)
             for i in range(6)] +
            [(60.0, "submit", rng.randrange(ws), 2),
             (100.0, "submit", rng.randrange(ws), 2),
             (150.0, "submit", rng.randrange(ws), 2)])
        return FabricScenario(world_size=ws, seed=seed, script=script,
                              duration=240.0, decode_interval=0.5,
                              weather=weather)
    if kind == "remedy_flap":
        # the remediation loop end-to-end (docs/DESIGN.md §22): rank
        # ws-1 flaps (the kill + restart stamps a restarted
        # incarnation into every fleet view), then a sustained loss
        # window turns the fabric's reliable traffic into a genuine
        # retransmit storm. A dead rank alone cannot trip the DEFAULT
        # storm rule — ARQ to a failed member stops at the 6s
        # declaration and the view-change forgiveness resets the rate
        # window — so the trip lands mid-loss with the flapper
        # identifiable, and the policy maps it to QUARANTINE. A
        # post-cooldown re-trip finds the flapper already quarantined
        # and falls back to BACKPRESSURE. The run must then recover:
        # drain exactly-once, un-quarantine after the clearing
        # window, decay backpressure to zero.
        victim = ws - 1
        gw = rng.randrange(ws - 1)  # never the victim
        script = (
            [(2.0 + 1.5 * i, "submit", rng.randrange(ws - 1), 2)
             for i in range(4)] +
            [(8.0, "kill", victim),
             (14.0, "submit", gw, 2),
             (16.0, "restart", victim),
             (24.0, "loss", 0.2),
             (26.0, "submit", gw, 3),
             (32.0, "submit", rng.randrange(ws - 1), 2),
             (38.0, "submit", gw, 2),
             (48.0, "loss", 0.0),
             (70.0, "submit", rng.randrange(ws - 1), 2),
             (120.0, "submit", gw, 2)])
        return FabricScenario(world_size=ws, seed=seed, script=script,
                              duration=190.0, decode_interval=0.5,
                              remedy=True, watchdog_cooldown=15.0,
                              expect_quarantine=victim)
    if kind == "remedy_hotspot":
        # a fleet-wide hot spell, no bad actor: 25% loss turns every
        # link into a retransmit storm with NO restarted incarnation
        # in sight, so the honest action is AIMD admission
        # backpressure, not a quarantine. Steady client load keeps
        # admissions flowing through the throttle; once the loss
        # clears the additive recovery must walk the level back to
        # zero and drain the deferred admits.
        script = (
            [(2.0 + 3.0 * i, "submit", rng.randrange(ws), 2)
             for i in range(5)] +
            [(15.0, "loss", 0.25)] +
            [(20.0 + 4.0 * i, "submit", rng.randrange(ws), 2)
             for i in range(5)] +
            [(40.0, "loss", 0.0),
             (55.0, "submit", rng.randrange(ws), 2),
             (70.0, "submit", rng.randrange(ws), 2)])
        return FabricScenario(world_size=ws, seed=seed, script=script,
                              duration=170.0, decode_interval=0.5,
                              remedy=True, watchdog_cooldown=15.0,
                              expect_backpressure=True)
    if kind == "remedy_split":
        # the no-dual-act property under a partition: rank ws-2 flaps
        # (becoming the identifiable quarantine candidate), then the
        # fleet splits majority/minority and a loss window storms the
        # majority's links. BOTH sides' watchdogs may trip; neither
        # may act — the minority cannot quarantine a rank outside its
        # own membership view, and the majority's quarantine would
        # fall below the STATIC min-alive quorum (max(2, ws//2+1))
        # while the minority is out. The re-tripping storm keeps the
        # pending want alive through the veto/retry loop; only after
        # the heal (full membership back) can the quarantine pass the
        # judges — exactly once, fleet-wide, both sides agreeing on
        # the quarantine set once healed.
        victim = ws - 2
        cut = [[r for r in range(ws) if r != ws - 1], [ws - 1]]
        gw = rng.randrange(ws - 2)  # never the victim or the minority
        script = (
            [(2.0 + 1.5 * i, "submit", rng.randrange(ws - 2), 2)
             for i in range(3)] +
            [(5.0, "kill", victim),
             (12.0, "restart", victim),
             (20.0, "partition", cut),
             (25.0, "loss", 0.18),
             (27.0, "submit", gw, 3),
             (33.0, "submit", gw, 2),
             (39.0, "submit", gw, 2),
             (55.0, "loss", 0.0),
             (70.0, "heal"),
             (85.0, "submit", gw, 2),
             (140.0, "submit", rng.randrange(ws - 2), 2)])
        return FabricScenario(world_size=ws, seed=seed, script=script,
                              duration=210.0, decode_interval=0.5,
                              remedy=True, watchdog_cooldown=15.0,
                              expect_quarantine=victim)
    if kind == "fabric_rejoin":
        victim = 0  # see fabric_kill: the warm-up owner
        gw = 1 + rng.randrange(ws - 1)
        script = (
            [(2.0 + 1.5 * i, "submit", rng.randrange(ws), 2)
             for i in range(4)] +
            [(13.0, "submit", gw, 3),
             (15.0, "kill", victim),
             (18.0, "submit", gw, 3),
             (40.0, "restart", victim),
             (120.0, "submit", gw, 2),
             (125.0, "submit", 1 + rng.randrange(ws - 1), 2)])
        return FabricScenario(world_size=ws, seed=seed, script=script,
                              duration=240.0, decode_interval=1.0)
    raise ValueError(f"unknown fabric scenario kind {kind!r}")


# single source of truth lives in transport/sim.py (declared there so
# the CLI sweep can enumerate the kinds without importing the serving
# layer); re-exported here for the serving-facing surface
FABRIC_SCENARIO_KINDS = _FABRIC_SCENARIO_KINDS
