"""In-band telemetry plane: digests over Tag.TELEM, aggregated
store-and-forward along the broadcast overlay (docs/DESIGN.md §17).

The port's own copy of ``rlo_tpu/observe/telemetry.py``, line for line:
only the imports and the logger names differ, so both packages give the
same results and the same bytes for the same seed
(``tests/test_torch_observe.py`` holds them equal).

Protocol in one paragraph: every ``interval`` (engine-clock) seconds a
rank samples its own engine telemetry into the fixed
``wire.TELEM_KEYS`` schema, delta-encodes it against its last emitted
sample (``wire.encode_telem``; every ``full_every``-th digest is a
full snapshot), applies it to its local :class:`FleetView`, and sends
it to its broadcast-overlay initiator targets as a reliable
``Tag.TELEM`` frame. A receiver drops duplicates by (origin, seq),
merges fresh digests into its own view, and forwards the RAW bytes
along ``fwd_targets(origin, sender)`` — the exact store-and-forward
shape the rootless broadcast uses, so digests reach every rank in
O(log n) hops with no designated collector. Delta application is
gap-safe: a digest that is neither FULL nor exactly one seq past the
last applied one parks the rank's entry as ``gap`` until the origin's
next full snapshot heals it (lost digests cost staleness, never
corruption).

The plane is pump-driven like the serving fabric: call ``pump()``
from the harness loop (it drains engine pickups and returns the
non-telemetry ones), or feed it messages with ``offer()`` when
another layer owns the pickup loop (``DecodeFabric`` does this when a
plane is attached). Clock and randomness: engine clock only — whole
instrumented fleets replay bit-for-bit in the simulator (rlo-lint R5
covers this module).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from rlo_tpu_torch.utils.metrics import (ENGINE_COUNTER_KEYS, HIST_BUCKETS,
                                         hist_summary)
from rlo_tpu_torch.wire import (TELEM_KEYS, TELEM_MAGIC, Tag, decode_telem,
                                encode_telem)

class _RankEntry:
    """One rank's slot in the fleet view."""
    __slots__ = ("values", "applied_seq", "seen_seq", "epoch",
                 "updated", "gap")

    def __init__(self):
        self.values: Dict[str, int] = {}
        self.applied_seq = -1   # last digest APPLIED to values
        self.seen_seq = -1      # highest digest seen (forward dedup)
        self.epoch = 0
        self.updated = float("-inf")
        self.gap = False        # lost a delta; healing on next full

    def apply(self, epoch: int, seq: int, full: bool,
              deltas: Dict[str, int], now: float) -> bool:
        """Merge one digest; True when it changed ``values``."""
        if full:
            self.values = {k: deltas.get(k, 0) for k in TELEM_KEYS}
            self.applied_seq = seq
            self.gap = False
        elif seq == self.applied_seq + 1 and not self.gap and \
                self.applied_seq >= 0:
            for k, d in deltas.items():
                self.values[k] = self.values.get(k, 0) + d
            self.applied_seq = seq
        else:
            # a delta with a hole under it: applying it would corrupt
            # the absolute values — park stale until the next full
            self.gap = True
            return False
        self.epoch = epoch
        self.updated = now
        return True


class FleetView:
    """Eventually-consistent per-rank telemetry + fleet rollups,
    staleness-stamped by membership epoch and digest age."""

    def __init__(self, world_size: int, self_rank: int):
        self.world_size = world_size
        self.self_rank = self_rank
        self.entries: Dict[int, _RankEntry] = {}

    def entry(self, rank: int) -> _RankEntry:
        ent = self.entries.get(rank)
        if ent is None:
            ent = self.entries[rank] = _RankEntry()
        return ent

    def ranks(self) -> List[int]:
        """Ranks with at least one applied digest."""
        return sorted(r for r, e in self.entries.items()
                      if e.applied_seq >= 0)

    def incarnations(self) -> Dict[int, int]:
        """Per-rank incarnation inferred from the digest seq space:
        seqs are partitioned ``incarnation << 20`` exactly like the
        engine's broadcast seqs, so the high bits of the last applied
        seq ARE the origin's incarnation at emission time. A rank
        with incarnation >= 1 has restarted at least once — the
        flapper signal the remediation policy keys on."""
        return {r: ent.applied_seq >> 20
                for r, ent in self.entries.items()
                if ent.applied_seq >= 0}

    def rollups(self) -> Dict[str, int]:
        """Fleet-wide SUM per key over every applied rank entry (the
        meaningful aggregate for the counter keys)."""
        out = {k: 0 for k in TELEM_KEYS}
        for ent in self.entries.values():
            if ent.applied_seq < 0:
                continue
            for k in TELEM_KEYS:
                out[k] += ent.values.get(k, 0)
        return out

    def rollup_max(self) -> Dict[str, int]:
        """Fleet-wide MAX per key (the meaningful aggregate for the
        gauge-shaped keys — epoch, lag, backlog, occupancy)."""
        out = {k: 0 for k in TELEM_KEYS}
        for ent in self.entries.values():
            if ent.applied_seq < 0:
                continue
            for k in TELEM_KEYS:
                v = ent.values.get(k, 0)
                if v > out[k]:
                    out[k] = v
        return out

    def snapshot(self, now: float,
                 self_epoch: Optional[int] = None) -> Dict:
        """JSON-ready view: per-rank values + staleness stamps, both
        rollups, and coverage (ranks present / world size)."""
        ranks = {}
        for r in self.ranks():
            ent = self.entries[r]
            ranks[str(r)] = {
                "values": {k: ent.values.get(k, 0)
                           for k in TELEM_KEYS},
                "seq": ent.applied_seq,
                "epoch": ent.epoch,
                "age": (now - ent.updated
                        if ent.updated != float("-inf") else None),
                "stale_epochs": (max(0, self_epoch - ent.epoch)
                                 if self_epoch is not None else None),
                "gap": ent.gap,
            }
        return {
            "from_rank": self.self_rank,
            "world_size": self.world_size,
            "present": len(ranks),
            "ranks": ranks,
            "rollups": self.rollups(),
            "rollup_max": self.rollup_max(),
        }


class TelemetryPlane:
    """One rank's membership in the telemetry plane (docs/DESIGN.md
    §17): periodic digest emission + store-and-forward aggregation
    over an existing :class:`~rlo_tpu_torch.engine.ProgressEngine`.

    ``interval`` paces emission on the ENGINE's clock (virtual time in
    the simulator); every ``full_every``-th digest is a full snapshot
    (the gap-healing cadence). ``extra`` is an optional callable
    returning app-level values for the non-engine schema keys
    (``pages_in_use``/``pages_free`` — the serving fabric wires its
    paged-pool gauges here). Nothing here touches the engine hot
    path: emission reads ``engine.metrics()`` at telemetry cadence
    and all frames ride the normal ``send_direct`` gate.
    """

    def __init__(self, engine, *, interval: float = 1.0,
                 full_every: int = 8,
                 extra: Optional[Callable[[], Dict[str, int]]] = None):
        if interval <= 0:
            raise ValueError(f"interval must be positive, got "
                             f"{interval}")
        if full_every < 1:
            raise ValueError(f"full_every must be >= 1, got "
                             f"{full_every}")
        self.engine = engine
        self.clock = engine.clock
        self.interval = interval
        self.full_every = full_every
        self.extra = extra
        self.view = FleetView(engine.world_size, engine.rank)
        self._prev: Optional[List[int]] = None
        # digest seqs are incarnation-partitioned exactly like the
        # engine's broadcast seqs (docs/DESIGN.md §8): a restarted
        # rank's fresh digests start above anything its previous life
        # emitted, so peers' (origin, seq) dedup never swallows them
        self._seq = engine.incarnation << 20
        self._next_emit = float("-inf")
        #: attached incident watchdog (observe/watchdog.py); checked
        #: once per emission interval, right after each digest
        self.watchdog = None
        # plane-level accounting (plain ints, plane-local)
        self.digests_emitted = 0
        self.digests_applied = 0
        self.digests_forwarded = 0
        self.digests_dropped = 0
        self.digests_malformed = 0

    # ------------------------------------------------------------------
    # sampling + emission
    # ------------------------------------------------------------------
    def sample(self) -> List[int]:
        """Current telemetry sample in TELEM_KEYS order: the engine
        counters, the per-link rollups (frames both ways, worst RTT
        EWMA), queue depth + pickup backlog, and the app extras."""
        m = self.engine.metrics()
        vals = [int(m["counters"][k]) for k in ENGINE_COUNTER_KEYS]
        links = m["links"].values()
        tx = sum(l["tx_frames"] for l in links)
        rx = sum(l["rx_frames"] for l in links)
        rtt = max((l["rtt_ewma_usec"] for l in links), default=0.0)
        q = m["queues"]
        ex = self.extra() if self.extra is not None else {}
        vals += [tx, rx, int(rtt), int(q["wait"]),
                 int(q["pickup"]) + int(q["wait_and_pickup"]),
                 int(ex.get("pages_in_use", 0)),
                 int(ex.get("pages_free", 0)),
                 int(ex.get("serve_inflight", 0)),
                 int(ex.get("ttft_p50_usec", 0)),
                 int(ex.get("ttft_p99_usec", 0)),
                 int(ex.get("e2e_p50_usec", 0)),
                 int(ex.get("e2e_p99_usec", 0)),
                 int(ex.get("coll_steps", 0)),
                 int(ex.get("coll_bytes", 0)),
                 int(ex.get("remedies_proposed", 0)),
                 int(ex.get("remedies_executed", 0)),
                 int(ex.get("quarantined", 0)),
                 int(ex.get("backpressure_level", 0))]
        return vals

    def emit(self, full: bool = False) -> Dict[str, int]:
        """Emit one digest now: sample, encode (delta vs the last
        emitted sample; full snapshot when forced, first, or at the
        full_every cadence), apply locally, and send to the broadcast
        overlay's initiator targets. Returns the captured absolute
        values keyed by TELEM_KEYS (what the digest pins — the parity
        anchor the fleet-rollup tests sum)."""
        eng = self.engine
        now = self.clock()
        base = eng.incarnation << 20
        if self._seq < base:
            # the engine rejoined with a bumped incarnation since the
            # last emit: re-base the digest seq space and re-anchor
            # receivers with a full snapshot
            self._seq = base
            full = True
        vals = self.sample()
        full = bool(full or self._prev is None or
                    self._seq % self.full_every == 0)
        raw = encode_telem(eng.rank, eng.epoch, self._seq, vals,
                           self._prev, full=full)
        captured = dict(zip(TELEM_KEYS, vals))
        self.view.entry(eng.rank).apply(eng.epoch, self._seq, True,
                                        captured, now)
        self.view.entry(eng.rank).seen_seq = self._seq
        self._prev = vals
        self._seq += 1
        self.digests_emitted += 1
        for dst in eng._cur_initiator_targets():
            eng.send_direct(dst, raw, tag=Tag.TELEM)
        return captured

    def flush(self) -> Dict[str, int]:
        """Force a FULL digest out now (test/shutdown convergence
        helper); returns the captured values like ``emit``."""
        return self.emit(full=True)

    # ------------------------------------------------------------------
    # receive + store-and-forward
    # ------------------------------------------------------------------
    def offer(self, msg) -> bool:
        """Feed one engine pickup to the plane; True when it was a
        telemetry digest (consumed), False otherwise (the caller's)."""
        if msg.type != int(Tag.TELEM) or \
                not msg.data.startswith(TELEM_MAGIC):
            return False
        self._on_digest(msg.data, msg.origin)
        return True

    def _on_digest(self, raw: bytes, sender: int) -> None:
        eng = self.engine
        try:
            rank, epoch, seq, full, deltas = decode_telem(raw)
        except ValueError:
            self.digests_malformed += 1
            return
        if rank == eng.rank or not 0 <= rank < eng.world_size:
            return  # an echo of my own digest, or a corrupt origin
        ent = self.view.entry(rank)
        if seq <= ent.seen_seq:
            # duplicate (multi-path forwarding): dropping it here is
            # what makes the store-and-forward loop-free
            self.digests_dropped += 1
            return
        ent.seen_seq = seq
        if ent.apply(epoch, seq, full, deltas, self.clock()):
            self.digests_applied += 1
        # store-and-forward along the overlay, exactly like the
        # rootless broadcast: the ORIGIN's position in the ring decides
        # the fan-out, the immediate sender prunes the backward edge
        for dst in eng._fwd_targets(rank, sender):
            self.digests_forwarded += 1
            eng.send_direct(dst, raw, tag=Tag.TELEM)

    # ------------------------------------------------------------------
    # the pump
    # ------------------------------------------------------------------
    def tick(self) -> None:
        """Emission + watchdog only — the half of ``pump`` for hosts
        that own the pickup loop themselves (the serving fabric feeds
        digests through ``offer`` and calls this once per pump)."""
        if self.engine.mid_rejoin:
            return
        now = self.clock()
        if now >= self._next_emit:
            self._next_emit = now + self.interval
            self.emit()
            # rule evaluation paces with emission: between digest
            # applications consecutive checks would see (near-)
            # identical aggregates, and a per-step check would put
            # two full-fleet rollup builds on the simulator's drive
            # loop for nothing
            if self.watchdog is not None:
                self.watchdog.check()

    def pump(self) -> List:
        """One plane turn: drain engine pickups (returning the
        non-telemetry ones for the embedding app), emit when due, and
        run the attached watchdog. No-op while the engine is
        mid-rejoin (its frames are quarantined fleet-wide)."""
        eng = self.engine
        if eng.mid_rejoin:
            return []
        unhandled: List = []
        while (m := eng.pickup_next()) is not None:
            if not self.offer(m):
                unhandled.append(m)
        self.tick()
        return unhandled

    def stats(self) -> Dict:
        """Plane-level accounting snapshot."""
        return {
            "emitted": self.digests_emitted,
            "applied": self.digests_applied,
            "forwarded": self.digests_forwarded,
            "dropped": self.digests_dropped,
            "malformed": self.digests_malformed,
            "view_present": len(self.view.ranks()),
        }


# ---------------------------------------------------------------------------
# Shared rollup helpers: the ONE merge implementation for fleet-level
# aggregation — ``serving.fabric.fleet_stats`` consumes these instead
# of keeping its own bespoke merge (docs/DESIGN.md §17).
# ---------------------------------------------------------------------------

def merge_counter_dicts(dicts: Sequence[Dict[str, int]]
                        ) -> Dict[str, int]:
    """Sum counter dicts key-wise (missing keys are zero)."""
    out: Dict[str, int] = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def merge_histograms(snaps: Sequence[Dict]) -> Dict:
    """Merge histogram SNAPSHOTS (the metrics.Histogram dict shape)
    into one summary: bucket-wise sums, min-of-mins, max-of-maxes —
    returned through ``hist_summary`` (count/mean/percentiles)."""
    merged = {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
              "buckets": None}
    for h in snaps:
        if not h or not h.get("count"):
            continue
        if merged["count"] == 0:
            merged["min"], merged["max"] = h["min"], h["max"]
            merged["buckets"] = list(h["buckets"])
        else:
            merged["min"] = min(merged["min"], h["min"])
            merged["max"] = max(merged["max"], h["max"])
            for i, b in enumerate(h["buckets"]):
                merged["buckets"][i] += b
        merged["count"] += h["count"]
        merged["sum"] += h["sum"]
    if merged["buckets"] is None:
        merged["buckets"] = [0] * HIST_BUCKETS
    return hist_summary(merged)
