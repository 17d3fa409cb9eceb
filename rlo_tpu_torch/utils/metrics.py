"""Serving metrics registry: counters, gauges, log2 histograms.

The port's own copy of the serving face of ``rlo_tpu/utils/metrics.py``
(``Counter``, ``Gauge``, ``Histogram``, ``Registry``, ``SERVING``,
``hist_quantile``, ``hist_summary``), with the same histogram layout and
snapshot schema, so a snapshot of the port's ``DecodeServer`` compares
key for key with the JAX package's. The engine-counter schemas of that
module belong to the engines and are not copied.

  - ``Counter``: monotone int, ``inc()``;
  - ``Gauge``: last-written value, ``set()``;
  - ``Histogram``: power-of-two buckets over non-negative values (bucket
    i holds values whose integer part has bit_length i, i.e.
    [2^(i-1), 2^i); bucket 0 is <= 0; the last bucket is overflow) with
    count/sum/min/max.
"""

from __future__ import annotations

from typing import Dict, List, Optional

#: number of histogram buckets (the JAX package's HIST_BUCKETS)
HIST_BUCKETS = 28


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
