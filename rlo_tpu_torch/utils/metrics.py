"""Serving metrics registry: counters, gauges, log2 histograms.

The port's own copy of the serving face of ``rlo_tpu/utils/metrics.py``
(``Counter``, ``Gauge``, ``Histogram``, ``Registry``, ``SERVING``,
``hist_quantile``, ``hist_summary``), with the same histogram layout and
snapshot schema, so a snapshot of the port's ``DecodeServer`` compares
key for key with the JAX package's, and of its engine face
(``ENGINE_COUNTER_KEYS``, ``ENGINE_PHASE_KEYS``, ``LinkStats``), so the
port's progress engine snapshots its metrics in the same schema.

  - ``Counter``: monotone int, ``inc()``;
  - ``Gauge``: last-written value, ``set()``;
  - ``Histogram``: power-of-two buckets over non-negative values (bucket
    i holds values whose integer part has bit_length i, i.e.
    [2^(i-1), 2^i); bucket 0 is <= 0; the last bucket is overflow) with
    count/sum/min/max.
"""

from __future__ import annotations

from typing import Dict, List, Optional

#: number of histogram buckets — mirror of RLO_HIST_BUCKETS (rlo_core.h)
HIST_BUCKETS = 28  # rlo-lint: paired-with rlo_core.h:RLO_HIST_BUCKETS

#: The engine-counter schema, in snapshot order — the single source of
#: truth for the ``metrics()["counters"]`` keys both engines emit
#: (ProgressEngine.metrics() and bindings.NativeEngine.metrics() build
#: from this tuple; the parity test asserts the dicts are identical).
#: ``epoch`` is the current membership epoch (monotone view counter),
#: ``epoch_quarantined`` counts frames dropped by the stale-epoch /
#: failed-sender quarantine, and ``rejoins`` counts membership
#: admissions executed (or adopted, on the joiner side) —
#: docs/DESIGN.md §8.
#:
#: The heal-cost block (docs/DESIGN.md §17 — the signals the
#: rejoin-cascade work of ROADMAP item 4 steers by):
#:   ``view_changes``       membership-view rebinds (failure adoptions
#:                          + admissions + welcome adoptions)
#:   ``reflood_frames``     frames re-sent by the view-change re-flood
#:                          (the O(n²·ring) heal cost, per frame×dst)
#:   ``epoch_lag_max``      high-water mark of (my epoch − the link
#:                          epoch stamped in an ACCEPTED frame): how
#:                          far this rank's view has outrun the edges
#:                          it still hears from (laggard pressure)
#:   ``quar_mid_rejoin`` / ``quar_failed_sender`` / ``quar_below_floor``
#:                          the per-reason breakdown of
#:                          ``epoch_quarantined`` (they sum to it)
#:   ``admission_rounds``   IAR admission rounds LAUNCHED here (the
#:                          designated-admitter's proposer-side count)
#:   ``epoch_syncs``        view-state catch-up adoptions executed via
#:                          Tag.MSYNC (an epoch-lagging but alive
#:                          member healed WITHOUT a full rejoin)
#:   ``reflood_skipped``    view-change re-flood advert entries the
#:                          receiving side already held — the work the
#:                          digest-scoped re-flood avoided (each would
#:                          have been one blast frame pre-PR-16)
#:   ``batched_admits``     joiners admitted through a MULTI-joiner
#:                          admission record (one IAR round admitting
#:                          k queued petitions at once)
# rlo-lint: paired-with rlo_core.h:rlo_stats
ENGINE_COUNTER_KEYS = (
    "sent_bcast", "recved_bcast", "total_pickup", "ops_failed",
    "arq_retransmits", "arq_dup_drops", "arq_gave_up", "arq_unacked",
    "epoch", "epoch_quarantined", "rejoins",
    "view_changes", "reflood_frames", "epoch_lag_max",
    "quar_mid_rejoin", "quar_failed_sender", "quar_below_floor",
    "admission_rounds",
    "epoch_syncs", "reflood_skipped", "batched_admits",
)

#: The in-engine phase-profiler schema, in snapshot order — the single
#: source of truth for the ``metrics()["phases"]`` keys both engines
#: emit (ProgressEngine.metrics() and bindings.NativeEngine.metrics()
#: build from this tuple; rlo-lint R2 pins it to the field order of the
#: C core's ``struct rlo_phase_stats`` and to the literal keys the
#: Python engine assembles, and the profiler parity test asserts the
#: snapshots are structurally identical). Each key names one log2
#: histogram of stage durations in usec (docs/DESIGN.md §10):
#:
#:   hot-path stages —
#:     ``frame_encode``   wire-frame encode (header pack + payload)
#:     ``frame_decode``   wire-frame decode on receipt
#:     ``send``           one transport isend call (the syscall slot)
#:     ``arq_scan``       one ARQ retransmit-window sweep
#:     ``tag_dispatch``   tag dispatch + handler for one protocol frame
#:     ``pickup_drain``   one pickup_next delivery
#:   per-op protocol phases (local observation points) —
#:     ``bcast_first_fwd``        bcast init -> FIRST fan-out send done
#:     ``bcast_all_delivered``    bcast init -> every fan-out send done
#:     ``prop_votes_aggregated``  proposal submit -> all votes merged
#:     ``prop_decision``          proposal submit -> decision fan-out done
# rlo-lint: paired-with rlo_core.h:rlo_phase_stats
ENGINE_PHASE_KEYS = (
    "frame_encode", "frame_decode", "send", "arq_scan", "tag_dispatch",
    "pickup_drain", "bcast_first_fwd", "bcast_all_delivered",
    "prop_votes_aggregated", "prop_decision",
)


class Counter:
    """Monotonically increasing integer."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written value."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Log2-bucketed histogram of non-negative samples (usec by
    convention). Bucket i counts samples whose int part has bit_length
    i; bucket 0 counts samples < 1 and the last bucket absorbs
    overflow."""
    __slots__ = ("count", "sum", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = 0.0
        self.max = 0.0
        self.buckets: List[int] = [0] * HIST_BUCKETS

    @staticmethod
    def bucket_index(v) -> int:
        iv = int(v)
        if iv <= 0:
            return 0
        return min(HIST_BUCKETS - 1, iv.bit_length())

    def observe(self, v: float) -> None:
        v = float(v)
        if self.count == 0:
            self.min = v
            self.max = v
        else:
            self.min = min(self.min, v)
            self.max = max(self.max, v)
        self.count += 1
        self.sum += v
        self.buckets[self.bucket_index(v)] += 1

    def snapshot(self) -> Dict:
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "buckets": list(self.buckets)}

    def quantile(self, q: float) -> Optional[float]:
        """Approximate quantile (``hist_quantile`` of the snapshot);
        None while empty. The serving fabric reads its p50/p99."""
        return hist_quantile(self.snapshot(), q)

    def p50(self) -> Optional[float]:
        return self.quantile(0.50)

    def p99(self) -> Optional[float]:
        return self.quantile(0.99)


class LinkStats:
    """Per-peer link accounting (one per (this rank, peer) edge):
    frames/bytes both ways, retransmits, duplicate drops, and an RTT
    EWMA measured from ARQ ack timing (first-transmission frames only —
    Karn's rule — smoothed 1/8 like TCP's SRTT). Mirror of the C
    core's rlo_link_stats."""
    __slots__ = ("tx_frames", "tx_bytes", "rx_frames", "rx_bytes",
                 "retransmits", "dup_drops", "rtt_ewma_usec")

    def __init__(self):
        self.tx_frames = 0
        self.tx_bytes = 0
        self.rx_frames = 0
        self.rx_bytes = 0
        self.retransmits = 0
        self.dup_drops = 0
        self.rtt_ewma_usec = 0.0

    def rtt_sample(self, usec: float) -> None:
        if usec < 1.0:
            # below clock resolution; clamp so a real sample can never
            # collide with the 0.0 "unmeasured" sentinel
            usec = 1.0
        if self.rtt_ewma_usec == 0.0:
            self.rtt_ewma_usec = usec
        else:
            self.rtt_ewma_usec += (usec - self.rtt_ewma_usec) / 8.0

    def snapshot(self) -> Dict:
        return {"tx_frames": self.tx_frames, "tx_bytes": self.tx_bytes,
                "rx_frames": self.rx_frames, "rx_bytes": self.rx_bytes,
                "retransmits": self.retransmits,
                "dup_drops": self.dup_drops,
                "rtt_ewma_usec": self.rtt_ewma_usec}


class Registry:
    """Named metrics, grouped by kind; snapshot() is a nested dict."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self._histograms.setdefault(name, Histogram())

    def snapshot(self) -> Dict:
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(self._histograms.items())},
        }


#: process-default serving registry: the port's DecodeServer and
#: generate_timed record here unless handed their own Registry
SERVING = Registry()


def hist_quantile(hist: Dict, q: float) -> Optional[float]:
    """Approximate quantile (bucket upper bound) from a histogram
    snapshot, good to a factor of 2. None when the histogram is
    empty."""
    n = hist["count"]
    if n == 0:
        return None
    want = q * n
    seen = 0
    for i, c in enumerate(hist["buckets"]):
        seen += c
        if seen >= want and c:
            if i == HIST_BUCKETS - 1:
                return float(hist["max"])
            return float(2 ** i)
    return float(hist["max"])


def hist_summary(hist: Dict) -> Dict:
    """Percentile digest of a histogram snapshot: count/mean/min/max +
    p50/p90/p99 estimated from the log2 buckets."""
    n = hist["count"]
    return {
        "count": n,
        "mean": (hist["sum"] / n) if n else None,
        "min": hist["min"] if n else None,
        "max": hist["max"] if n else None,
        "p50": hist_quantile(hist, 0.50),
        "p90": hist_quantile(hist, 0.90),
        "p99": hist_quantile(hist, 0.99),
    }
