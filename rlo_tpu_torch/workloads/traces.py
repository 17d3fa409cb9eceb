"""Trace generator: seeded, clock-free, replayable request streams
(docs/DESIGN.md §14 — the traffic half of the planet-scale traffic
laboratory, ROADMAP item 4).

The port's own copy of ``rlo_tpu/workloads/traces.py``, line for line:
only the imports and the logger names differ, so both packages give the
same results and the same bytes for the same seed
(``tests/test_torch_workloads.py`` holds them equal).

Every generator is a pure function of its seed + config — no wall
clock, no module-level randomness (rlo-lint R5 scope) — and produces a
:class:`Trace`: an ordered list of :class:`TraceRequest` records on an
abstract time axis (the CONSUMER decides what a time unit means:
decode rounds for ``serve_bench``, virtual seconds for
``fabric_bench``/the simulator). Traces serialize to a compact JSONL
format (header line with a schema version + config, then one array per
request) and carry a ``digest()`` — SHA-256 over the canonical request
stream — so benchmarks pin traces seed-exact: a generator change that
moves one token fails the perf gate mechanically, not anecdotally.

The canned workload shapes (``make_trace(kind, seed)``):

  - ``diurnal``  — sinusoidal day/night rate wave (NHPP via thinning);
  - ``mmpp``     — bursty multi-tenant arrivals: each tenant is an
    on/off Markov-modulated Poisson process with exponential on/off
    dwell times (traffic arrives in correlated per-tenant bursts);
  - ``flash``    — steady background plus a flash crowd: an
    exponentially decaying arrival spike landing mid-trace;
  - ``swarm``    — shared-prefix agent swarms: requests share one of
    ``n_prefixes`` system prefixes, picked by a tunable Zipf
    prefix-reuse distribution (``zipf_alpha``) — the radix-cache /
    COW stress shape.

``poisson_compat`` is the byte-identical migration shim for
``serve_bench --arrivals poisson``: the exact numpy draw sequence the
bench historically made inline, so the three committed
BENCH_serve.json legs keep their values (and the bench asserts the
pinned trace digests).
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
from dataclasses import dataclass, field
from random import Random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

logger = logging.getLogger("rlo_tpu_torch.workloads")

#: bump on any change to the JSONL layout; load_jsonl refuses newer
#: schemas instead of misparsing them
TRACE_SCHEMA = 1

TRACE_KINDS = ("diurnal", "mmpp", "flash", "swarm")


class TraceError(ValueError):
    """Unusable trace input (bad header, unsupported schema)."""


@dataclass(frozen=True)
class TraceRequest:
    """One client request on the abstract trace time axis."""
    t: float                  # arrival time (unit = consumer's choice)
    tenant: int               # originating tenant / swarm id
    max_new: int              # decode budget
    prompt: Tuple[int, ...]   # prompt token ids

    def row(self) -> list:
        """The compact JSONL array form (also the digest canonical
        form): ``[t, tenant, max_new, [tokens...]]``."""
        return [self.t, self.tenant, self.max_new, list(self.prompt)]


def trace_digest(rows: Iterable[Sequence]) -> str:
    """SHA-256 over canonical ``[t, tenant, max_new, [tokens...]]``
    rows. Floats hash via json's shortest-repr — deterministic for
    equal values — so equal traces digest equal on any host."""
    h = hashlib.sha256()
    for t, tenant, max_new, prompt in rows:
        h.update(json.dumps(
            [t, int(tenant), int(max_new),
             [int(x) for x in prompt]],
            separators=(",", ":")).encode())
        h.update(b"\n")
    return h.hexdigest()


@dataclass
class Trace:
    """A replayable request stream: header + ordered requests."""
    kind: str
    seed: int
    config: Dict
    requests: List[TraceRequest] = field(default_factory=list)
    #: requests lost to a truncated JSONL load (0 for generated traces)
    truncated: int = 0

    def digest(self) -> str:
        """Seed-exact identity of the stream: covers the schema, kind,
        seed, config, and every request row."""
        h = hashlib.sha256()
        h.update(json.dumps(
            {"schema": TRACE_SCHEMA, "kind": self.kind,
             "seed": self.seed, "config": self.config},
            sort_keys=True, separators=(",", ":")).encode())
        h.update(b"\n")
        h.update(trace_digest(r.row() for r in self.requests).encode())
        return h.hexdigest()

    # -- JSONL serialization ------------------------------------------
    def dumps(self) -> str:
        head = {"schema": TRACE_SCHEMA, "kind": self.kind,
                "seed": self.seed, "n": len(self.requests),
                "config": self.config}
        lines = [json.dumps(head, sort_keys=True,
                            separators=(",", ":"))]
        lines.extend(json.dumps(r.row(), separators=(",", ":"))
                     for r in self.requests)
        return "\n".join(lines) + "\n"

    def dump_jsonl(self, path) -> None:
        with open(path, "w") as fh:
            fh.write(self.dumps())

    @classmethod
    def loads(cls, text: str) -> "Trace":
        lines = text.splitlines()
        if not lines or not lines[0].strip():
            raise TraceError("empty trace (no header line)")
        try:
            head = json.loads(lines[0])
        except json.JSONDecodeError as e:
            raise TraceError(f"unreadable trace header: {e}")
        if not isinstance(head, dict) or "schema" not in head:
            raise TraceError("first line is not a trace header "
                             "(missing 'schema')")
        if head["schema"] > TRACE_SCHEMA:
            raise TraceError(
                f"trace schema {head['schema']} is newer than this "
                f"reader ({TRACE_SCHEMA})")
        reqs: List[TraceRequest] = []
        bad = 0
        for i, line in enumerate(lines[1:], start=2):
            if not line.strip():
                continue
            try:
                t, tenant, max_new, prompt = json.loads(line)
                reqs.append(TraceRequest(float(t), int(tenant),
                                         int(max_new),
                                         tuple(int(x)
                                               for x in prompt)))
            except (json.JSONDecodeError, TypeError, ValueError):
                # truncated-file tolerance: a torn tail (partial last
                # line from an interrupted writer) keeps the surviving
                # prefix usable — but loudly, and only at the tail
                bad = len(lines) - i + 1
                logger.warning(
                    "trace truncated at line %d: keeping %d parsed "
                    "requests, dropping the rest of the file "
                    "(%d line(s))", i, len(reqs), bad)
                break
        want = head.get("n")
        if want is not None and want > len(reqs):
            if not bad:
                logger.warning(
                    "trace header promises %d requests, file holds "
                    "%d (truncated copy?)", want, len(reqs))
            bad = max(bad, want - len(reqs))
        return cls(kind=head.get("kind", "?"),
                   seed=int(head.get("seed", -1)),
                   config=head.get("config", {}), requests=reqs,
                   truncated=max(bad, 0))

    @classmethod
    def load_jsonl(cls, path) -> "Trace":
        try:
            with open(path) as fh:
                return cls.loads(fh.read())
        except OSError as e:
            raise TraceError(f"cannot read trace {path}: {e}")

    # -- consumer adapters --------------------------------------------
    def serve_requests(self) -> Tuple[List[Tuple[Tuple[int, ...], int]],
                                      List[int]]:
        """(requests, arrival) in ``serve_bench`` open-loop form:
        prompts + budgets plus per-request arrival ROUND (the abstract
        time floor-quantized)."""
        reqs = [(r.prompt, r.max_new) for r in self.requests]
        arrival = [int(r.t) for r in self.requests]
        return reqs, arrival

    def fabric_arrivals(self, gateways: Sequence[int],
                        time_scale: float = 1.0,
                        start: float = 1.0
                        ) -> List[Tuple[float, int, Tuple[int, ...],
                                        int]]:
        """(vtime, gateway, prompt, max_new) rows for fabric benches:
        tenants map round-robin onto the given gateway ranks, times
        scale onto the virtual-time axis."""
        return [(start + r.t * time_scale,
                 gateways[r.tenant % len(gateways)], r.prompt,
                 r.max_new)
                for r in self.requests]


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

def _mk_prompt(rng: Random, vocab: int, plen: Tuple[int, int]
               ) -> Tuple[int, ...]:
    n = rng.randrange(plen[0], plen[1] + 1)
    return tuple(rng.randrange(1, vocab) for _ in range(n))


def _mk_budget(rng: Random, budget: Tuple[int, int]) -> int:
    return rng.randrange(budget[0], budget[1] + 1)


def diurnal(seed: int, *, horizon: float = 240.0,
            base_rate: float = 0.4, peak_rate: float = 2.5,
            period: float = 120.0, tenants: int = 4,
            vocab: int = 32768, plen: Tuple[int, int] = (4, 12),
            budget: Tuple[int, int] = (4, 24)) -> Trace:
    """Sinusoidal day/night wave: a nonhomogeneous Poisson process at
    rate(t) = base + (peak-base) * (1 + sin(2πt/period - π/2)) / 2,
    realized by thinning a homogeneous ``peak_rate`` process — the
    trough sits at ``base_rate``, the crest at ``peak_rate``."""
    rng = Random(seed)
    cfg = dict(horizon=horizon, base_rate=base_rate,
               peak_rate=peak_rate, period=period, tenants=tenants,
               vocab=vocab, plen=list(plen), budget=list(budget))
    reqs: List[TraceRequest] = []
    t = 0.0
    while True:
        t += rng.expovariate(peak_rate)
        if t >= horizon:
            break
        rate = base_rate + (peak_rate - base_rate) * 0.5 * (
            1.0 + math.sin(2.0 * math.pi * t / period - math.pi / 2))
        if rng.random() * peak_rate >= rate:
            continue  # thinned
        reqs.append(TraceRequest(round(t, 6), rng.randrange(tenants),
                                 _mk_budget(rng, budget),
                                 _mk_prompt(rng, vocab, plen)))
    return Trace("diurnal", seed, cfg, reqs)


def mmpp(seed: int, *, horizon: float = 240.0, tenants: int = 6,
         tenant_rate: float = 1.2, mean_on: float = 12.0,
         mean_off: float = 36.0, vocab: int = 32768,
         plen: Tuple[int, int] = (4, 12),
         budget: Tuple[int, int] = (4, 24)) -> Trace:
    """Bursty multi-tenant arrivals: every tenant is an independent
    on/off MMPP — exponential dwell times (``mean_on`` / ``mean_off``)
    modulating a ``tenant_rate`` Poisson process — so the merged
    stream arrives in correlated per-tenant bursts, not a smooth
    Poisson blur. Tenants are generated in order from one seeded rng
    and merged by (t, tenant), keeping the stream reproducible."""
    rng = Random(seed)
    cfg = dict(horizon=horizon, tenants=tenants,
               tenant_rate=tenant_rate, mean_on=mean_on,
               mean_off=mean_off, vocab=vocab, plen=list(plen),
               budget=list(budget))
    rows: List[TraceRequest] = []
    for tenant in range(tenants):
        t = 0.0
        # stagger: tenants start in a random phase of their off period
        t += rng.random() * mean_off
        while t < horizon:
            on_end = t + rng.expovariate(1.0 / mean_on)
            while True:
                t += rng.expovariate(tenant_rate)
                if t >= on_end or t >= horizon:
                    break
                rows.append(TraceRequest(
                    round(t, 6), tenant, _mk_budget(rng, budget),
                    _mk_prompt(rng, vocab, plen)))
            t = max(t, on_end) + rng.expovariate(1.0 / mean_off)
    rows.sort(key=lambda r: (r.t, r.tenant))
    return Trace("mmpp", seed, cfg, rows)


def flash(seed: int, *, horizon: float = 240.0, base_rate: float = 0.5,
          flash_at: float = 80.0, flash_mult: float = 12.0,
          flash_decay: float = 15.0, tenants: int = 4,
          vocab: int = 32768, plen: Tuple[int, int] = (4, 12),
          budget: Tuple[int, int] = (4, 24)) -> Trace:
    """Flash crowd: steady ``base_rate`` background plus an arrival
    spike at ``flash_at`` whose extra rate starts at ``base_rate *
    flash_mult`` and decays exponentially with time constant
    ``flash_decay`` (thinning against the peak total rate)."""
    rng = Random(seed)
    cfg = dict(horizon=horizon, base_rate=base_rate,
               flash_at=flash_at, flash_mult=flash_mult,
               flash_decay=flash_decay, tenants=tenants, vocab=vocab,
               plen=list(plen), budget=list(budget))
    peak = base_rate * (1.0 + flash_mult)
    reqs: List[TraceRequest] = []
    t = 0.0
    while True:
        t += rng.expovariate(peak)
        if t >= horizon:
            break
        rate = base_rate
        if t >= flash_at:
            rate += base_rate * flash_mult * math.exp(
                -(t - flash_at) / flash_decay)
        if rng.random() * peak >= rate:
            continue
        reqs.append(TraceRequest(round(t, 6), rng.randrange(tenants),
                                 _mk_budget(rng, budget),
                                 _mk_prompt(rng, vocab, plen)))
    return Trace("flash", seed, cfg, reqs)


def swarm(seed: int, *, horizon: float = 240.0, rate: float = 1.5,
          n_prefixes: int = 8, zipf_alpha: float = 1.2,
          prefix_len: Tuple[int, int] = (8, 24),
          vocab: int = 32768, plen: Tuple[int, int] = (2, 8),
          budget: Tuple[int, int] = (4, 24)) -> Trace:
    """Shared-prefix agent swarms: a pool of ``n_prefixes`` system
    prefixes; each request draws its prefix from a truncated Zipf
    (rank k with weight 1/k^``zipf_alpha`` — the tunable prefix-reuse
    distribution), then appends a unique suffix. ``tenant`` is the
    prefix index, so consumers can observe per-swarm locality; the
    radix-cache / COW stress shape (docs/DESIGN.md §12)."""
    rng = Random(seed)
    cfg = dict(horizon=horizon, rate=rate, n_prefixes=n_prefixes,
               zipf_alpha=zipf_alpha, prefix_len=list(prefix_len),
               vocab=vocab, plen=list(plen), budget=list(budget))
    prefixes = [_mk_prompt(rng, vocab, prefix_len)
                for _ in range(n_prefixes)]
    weights = [1.0 / ((k + 1) ** zipf_alpha)
               for k in range(n_prefixes)]
    total = sum(weights)
    cum, acc = [], 0.0
    for w in weights:
        acc += w / total
        cum.append(acc)
    reqs: List[TraceRequest] = []
    t = 0.0
    while True:
        t += rng.expovariate(rate)
        if t >= horizon:
            break
        u = rng.random()
        pi = next(i for i, c in enumerate(cum) if u < c or
                  i == n_prefixes - 1)
        reqs.append(TraceRequest(
            round(t, 6), pi, _mk_budget(rng, budget),
            prefixes[pi] + _mk_prompt(rng, vocab, plen)))
    return Trace("swarm", seed, cfg, reqs)


_GENERATORS = {"diurnal": diurnal, "mmpp": mmpp, "flash": flash,
               "swarm": swarm}


def make_trace(kind: str, seed: int, **overrides) -> Trace:
    """One of the canned workload shapes (``TRACE_KINDS``), seeded;
    keyword overrides flow into the generator config (and the
    digest)."""
    gen = _GENERATORS.get(kind)
    if gen is None:
        raise TraceError(f"unknown trace kind {kind!r}; known: "
                         f"{', '.join(TRACE_KINDS)}")
    return gen(seed, **overrides)


# ---------------------------------------------------------------------------
# serve_bench compatibility shim
# ---------------------------------------------------------------------------

def poisson_compat(vocab: int, *, n_req: int, rate: float, seed: int,
                   max_len: int, buckets: Sequence[int],
                   prefix_len: int = 0):
    """The serve_bench ``--arrivals poisson`` trace, relocated —
    BYTE-IDENTICAL to the generator that lived inline in
    benchmarks/serve_bench.py (same
    ``numpy.random.default_rng(seed)`` draw sequence), so the three
    committed BENCH_serve.json legs reproduce exactly. Returns
    ``(requests, arrival)``: bimodal short-interactive / long-batch
    requests plus per-round cumulative-Poisson arrival rounds.
    ``prefix_len > 0`` prepends a shared system prefix to ~70% of
    prompts and resubmits ~25% of prompts exactly (the radix/COW
    variant). New consumers should prefer the native generators
    above; this shim exists so the committed serving baseline never
    moves out from under the perf gate."""
    import numpy as np  # lazy: the sim-side workloads stay jax/numpy-free

    rng = np.random.default_rng(seed)
    prefix = (rng.integers(0, vocab, (prefix_len,))
              if prefix_len else None)
    reqs = []
    for _ in range(n_req):
        if rng.random() < 0.7:  # short interactive
            plen = int(rng.integers(3, 9))
            budget = int(rng.integers(4, 13))
        else:                   # long batch
            plen = int(rng.integers(8, min(15, buckets[-1] + 1)))
            budget = int(rng.integers(24, min(41, max_len - plen)))
        prompt = rng.integers(0, vocab, (plen,))
        if prefix is not None and rng.random() < 0.7:
            prompt = np.concatenate([prefix, prompt])
        if prefix is not None and reqs and rng.random() < 0.25:
            # an exact resubmission: the full-prefix radix hit whose
            # first decode write lands in a shared page — the COW path
            prompt = reqs[rng.integers(0, len(reqs))][0]
        reqs.append((prompt, budget))
    # arrival round of each request: cumulative Poisson per round
    arrival, rnd = [], 0
    while len(arrival) < n_req:
        k = int(rng.poisson(rate))
        arrival.extend([rnd] * min(k, n_req - len(arrival)))
        rnd += 1
    return reqs, arrival


def compat_digest(reqs, arrival) -> str:
    """Digest of a ``poisson_compat``-shaped (requests, arrival) pair
    in the canonical trace-row form (tenant 0), so the migrated
    serve_bench legs can pin their traces seed-exact."""
    return trace_digest(
        (arr, 0, budget, [int(x) for x in prompt])
        for (prompt, budget), arr in zip(reqs, arrival))
