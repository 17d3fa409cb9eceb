"""rlo-top — fleet telemetry watch/snapshot CLI (docs/DESIGN.md §17).

The port's copy of ``rlo_tpu/tools/rlo_top.py``, over the port's
``wire.TELEM_KEYS``, telemetry plane and ``SimWorld``.

Renders the in-band telemetry plane's :class:`FleetView` — per-rank
frames/retransmits/RTT EWMA/epoch/queue depth/pickup backlog/page
occupancy plus fleet rollups — FROM ANY RANK: the view is assembled
from Tag.TELEM digests store-and-forwarded along the paper's own
broadcast overlay, so there is no collector to point at; every rank
holds (an eventually-consistent copy of) the whole fleet.

Self-contained by design, like ``timeline smoke``: the CLI builds a
seeded SimWorld fleet (optionally with the serving fabric on top),
drives scripted traffic, converges the plane, and renders the view
from ``--from-rank``. The same helpers (:func:`run_fleet`,
:func:`render`) are the programmatic face an embedding harness uses
against its own live engines.

Usage::

    python -m rlo_tpu_torch.tools.rlo_top                   # table snapshot
    python -m rlo_tpu_torch.tools.rlo_top --json            # machine output
    python -m rlo_tpu_torch.tools.rlo_top --watch 5         # 5 live frames
    python -m rlo_tpu_torch.tools.rlo_top --fabric          # serving fleet

Exit codes follow the shared tools convention (rlo_tpu_torch/tools/
runner.py): 0 ok, 1 self-check failed (a rank's digest missing from
the view, or rollups drifting from the per-rank captures), 2 bad
invocation.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

from rlo_tpu_torch.wire import TELEM_KEYS

#: the columns the table renders, (header, TELEM key, width)
_COLS = (
    ("tx", "tx_frames", 7), ("rx", "rx_frames", 7),
    ("retx", "arq_retransmits", 5), ("rtt_us", "rtt_ewma_max_usec", 7),
    ("epoch", "epoch", 5), ("lag", "epoch_lag_max", 4),
    ("q", "q_wait", 4), ("bklg", "pickup_backlog", 5),
    ("pg_use", "pages_in_use", 6), ("pg_free", "pages_free", 7),
    ("rejoin", "rejoins", 6), ("reflood", "reflood_frames", 7),
)

#: the §18 heal-counter block ``--fabric`` appends per rank: epoch
#: catch-up adoptions (MSYNC), advert re-flood entries skipped at the
#: receiver, and joiners admitted through multi-joiner batch records —
#: the serving fleet's healing-cost readout next to its page columns
_HEAL_COLS = (
    ("syncs", "epoch_syncs", 5), ("rfskip", "reflood_skipped", 6),
    ("badm", "batched_admits", 5),
)

#: the §22 remediation block rides the heal view too: how many ranks
#: each member currently quarantines and its AIMD admission-throttle
#: level — both IAR-decided, so a healthy converged fleet shows one
#: identical value down each column
_REMEDY_COLS = (
    ("quar", "quarantined", 4), ("bp", "backpressure_level", 3),
)

#: the serving-latency block ``--serve`` appends: in-flight requests
#: plus the per-rank p50/p99 TTFT and e2e latency gauges the fabric
#: publishes through the TELEM_EXTRA_KEYS digest extras
#: (docs/DESIGN.md §19) — fleet latency posture with no scrape path
_SERVE_COLS = (
    ("infl", "serve_inflight", 5),
    ("ttft50", "ttft_p50_usec", 8), ("ttft99", "ttft_p99_usec", 8),
    ("e2e50", "e2e_p50_usec", 8), ("e2e99", "e2e_p99_usec", 8),
)


class FleetHarness:
    """A driven sim fleet with one telemetry plane per rank — what
    ``run_fleet`` returns. ``fabrics`` is empty without ``--fabric``."""

    def __init__(self, world, manager, engines, planes, fabrics):
        self.world = world
        self.manager = manager
        self.engines = engines
        self.planes = planes
        self.fabrics = fabrics

    def pump_all(self) -> None:
        for r, plane in enumerate(self.planes):
            if r in self.world.dead:
                continue
            if self.fabrics:
                self.fabrics[r].pump()
            else:
                plane.pump()

    def drive(self, until_vtime: float,
              traffic_interval: float = 0.7) -> None:
        """Advance the fleet to ``until_vtime`` with round-robin
        traffic: plain broadcasts (or fabric request submissions when
        serving) every ``traffic_interval`` virtual seconds."""
        world = self.world
        n = world.world_size
        i = getattr(self, "_traffic_i", 0)
        next_traffic = getattr(self, "_next_traffic", 0.5)
        while world.now < until_vtime:
            if world.now >= next_traffic:
                next_traffic += traffic_interval
                r = i % n
                if r not in world.dead:
                    if self.fabrics:
                        self.fabrics[r].submit(
                            (1 + i % 7, 2 + i % 5, 3), max_new=4)
                    else:
                        self.engines[r].bcast(b"t%d" % i)
                i += 1
            world.step()
            self.manager.progress_all()
            self.pump_all()
        self._traffic_i = i
        self._next_traffic = next_traffic

    def converge(self, max_spins: int = 200_000) -> List[Dict[str,
                                                              int]]:
        """Flush a FULL digest from every live rank and drain until
        the plane is quiet; returns the per-rank captured values (the
        exact samples the final digests pinned — sum them to check
        the fleet rollups, which is what the check.sh smoke and the
        acceptance test do)."""
        world = self.world
        captured = []
        for r, plane in enumerate(self.planes):
            if r not in world.dead:
                captured.append(plane.flush())
        for _ in range(max_spins):
            world.step()
            self.manager.progress_all()
            for r, plane in enumerate(self.planes):
                if r in world.dead:
                    continue
                eng = self.engines[r]
                while (m := eng.pickup_next()) is not None:
                    if plane.offer(m):
                        continue
                    if self.fabrics:
                        # fabric records landing during the drain go
                        # through the record dispatch, not the floor
                        # (the plane is deliberately NOT ticked here:
                        # no further emission, so the final view stays
                        # equal to the flush captures)
                        self.fabrics[r].offer_record(m)
            if world.quiescent():
                break
        return captured

    def cleanup(self) -> None:
        for e in self.engines:
            e.cleanup()


def run_fleet(world_size: int = 8, seed: int = 0,
              interval: float = 1.0, fabric: bool = False,
              watchdog_rules: Optional[Sequence[str]] = None,
              incident_dir: Optional[str] = None) -> FleetHarness:
    """Build the seeded sim fleet: one engine + telemetry plane per
    rank (plus a StubBackend serving fabric with ``fabric=True``,
    planes attached through ``DecodeFabric.attach_telemetry`` so page
    occupancy rides the digests)."""
    from rlo_tpu_torch.engine import EngineManager, ProgressEngine
    from rlo_tpu_torch.observe import TelemetryPlane, Watchdog
    from rlo_tpu_torch.transport.sim import SimWorld

    world = SimWorld(world_size, seed=seed)
    mgr = EngineManager()
    engines = [ProgressEngine(world.transport(r), manager=mgr,
                              clock=world.clock, arq_rto=1.5)
               for r in range(world_size)]
    for e in engines:
        # the whole point is observability: per-link accounting on
        # (the digest's tx/rx/RTT extras read the metrics registry)
        e.enable_metrics()
    planes = [TelemetryPlane(e, interval=interval) for e in engines]
    fabrics = []
    if fabric:
        # the PAGED stub: real PageAllocator/PrefixTrie bookkeeping,
        # so the digests' page-occupancy keys carry live values
        from rlo_tpu_torch.serving.backend import PagedStubBackend
        from rlo_tpu_torch.serving.fabric import DecodeFabric
        for r in range(world_size):
            fab = DecodeFabric(engines[r], PagedStubBackend(n_slots=2),
                               decode_interval=0.25)
            fab.attach_telemetry(planes[r])
            fabrics.append(fab)
    if watchdog_rules is not None:
        # exactly one bundle writer (rank 0): "" pins the other
        # ranks' watchdogs off even when $RLO_INCIDENT_DIR is set
        for r, plane in enumerate(planes):
            Watchdog(plane, watchdog_rules, incident_dir=(
                incident_dir if r == 0 else ""), engines=engines)
    return FleetHarness(world, mgr, engines, planes, fabrics)


def render(snap: Dict, heal: bool = False,
           serve: bool = False) -> str:
    """Text table for one FleetView snapshot. ``heal=True`` (the
    ``--fabric`` view) appends the §18 heal-counter block and the §22
    remediation columns (quar/bp); ``serve=True`` appends the §19
    serving-latency block."""
    cols = _COLS + (_HEAL_COLS + _REMEDY_COLS if heal else ()) + \
        (_SERVE_COLS if serve else ())
    lines = [
        f"rlo-top — fleet view from rank {snap['from_rank']} "
        f"({snap['present']}/{snap['world_size']} ranks reporting)",
        "",
    ]
    hdr = "rank " + " ".join(f"{h:>{w}}" for h, _, w in cols) + \
        "   age  seq  stale gap"
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for r, ent in sorted(snap["ranks"].items(), key=lambda kv:
                         int(kv[0])):
        v = ent["values"]
        row = f"{r:>4} " + " ".join(
            f"{v.get(k, 0):>{w}}" for _, k, w in cols)
        age = ent.get("age")
        stale = ent.get("stale_epochs")
        row += (f"  {age:5.1f}" if age is not None else "      ")
        row += f" {ent['seq']:>4}"
        row += (f"  {stale:>5}" if stale is not None else "       ")
        row += "   *" if ent.get("gap") else ""
        lines.append(row)
    roll = snap["rollups"]
    lines.append("-" * len(hdr))
    lines.append("sum  " + " ".join(
        f"{roll.get(k, 0):>{w}}" for _, k, w in cols))
    rmax = snap["rollup_max"]
    lines.append("max  " + " ".join(
        f"{rmax.get(k, 0):>{w}}" for _, k, w in cols))
    return "\n".join(lines)


def _self_check(snap: Dict, captured: List[Dict[str, int]]) -> List[str]:
    """The smoke-mode invariants: every live rank's digest present,
    and the fleet rollups equal to the sum of the per-rank captures
    the final full digests pinned."""
    problems = []
    if snap["present"] != len(captured):
        problems.append(
            f"view holds {snap['present']} ranks, expected "
            f"{len(captured)}")
    sums = {k: sum(c[k] for c in captured) for k in TELEM_KEYS}
    for k in TELEM_KEYS:
        # EVERY key sums: the rollup adds the same per-rank applied
        # values the captures pin (gauges included — max-shaped only
        # for the fleet-level reading, not for this identity)
        if snap["rollups"].get(k) != sums[k]:
            problems.append(
                f"rollup {k}: view says {snap['rollups'].get(k)}, "
                f"per-rank captures sum to {sums[k]}")
    return problems


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rlo_tpu_torch.tools.rlo_top",
        description="Fleet telemetry watch/snapshot over the in-band "
                    "telemetry plane (docs/DESIGN.md §17).")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vtime", type=float, default=20.0,
                    help="virtual seconds of traffic to drive")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="digest emission interval (vsec)")
    ap.add_argument("--from-rank", type=int, default=0,
                    help="render the view as seen from this rank")
    ap.add_argument("--fabric", action="store_true",
                    help="drive a StubBackend serving fabric on top "
                         "(page occupancy rides the digests)")
    ap.add_argument("--serve", action="store_true",
                    help="append the serving-latency block (in-flight "
                         "+ p50/p99 TTFT/e2e from the digest extras); "
                         "implies --fabric")
    ap.add_argument("--watch", type=int, default=0, metavar="N",
                    help="render N live frames while driving instead "
                         "of one converged snapshot")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable snapshot on stdout")
    args = ap.parse_args(argv)
    if args.ranks < 2 or not 0 <= args.from_rank < args.ranks:
        print("rlo-top: error: need --ranks >= 2 and --from-rank in "
              "range", file=sys.stderr)
        return 2
    if args.serve:
        args.fabric = True  # the latency gauges ride the fabric

    import logging
    logging.getLogger("rlo_tpu_torch").setLevel(logging.ERROR)
    fleet = run_fleet(args.ranks, seed=args.seed,
                      interval=args.interval, fabric=args.fabric)
    plane = fleet.planes[args.from_rank]
    eng = fleet.engines[args.from_rank]

    if args.watch > 0:
        span = args.vtime / args.watch
        for frame in range(args.watch):
            fleet.drive(fleet.world.now + span)
            snap = plane.view.snapshot(fleet.world.now,
                                       self_epoch=eng.epoch)
            if args.json:
                print(json.dumps({"frame": frame,
                                  "vtime": fleet.world.now,
                                  "fleet": snap}))
            else:
                print(f"\n== frame {frame} (vtime "
                      f"{fleet.world.now:.1f}) ==")
                print(render(snap, heal=args.fabric,
                             serve=args.serve))
        fleet.cleanup()
        return 0

    fleet.drive(args.vtime)
    captured = fleet.converge()
    snap = plane.view.snapshot(fleet.world.now, self_epoch=eng.epoch)
    problems = _self_check(snap, captured)
    if args.json:
        out = {"ok": not problems, "from_rank": args.from_rank,
               "vtime": fleet.world.now, "fleet": snap,
               "plane": plane.stats(), "problems": problems}
        if args.fabric:
            from rlo_tpu_torch.serving.fabric import fleet_stats
            out["fleet_stats_counters"] = fleet_stats(
                fleet.fabrics)["counters"]
        print(json.dumps(out))
    else:
        print(render(snap, heal=args.fabric, serve=args.serve))
        if problems:
            print("\nSELF-CHECK FAILED:", file=sys.stderr)
            for p in problems:
                print(f"  {p}", file=sys.stderr)
    fleet.cleanup()
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
