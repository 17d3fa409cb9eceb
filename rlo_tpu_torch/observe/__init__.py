"""Fleet telescope: the rootless in-band telemetry plane
(docs/DESIGN.md §17).

The port's own copy of ``rlo_tpu/observe/__init__.py``, line for line:
only the imports and the logger names differ, so both packages give the
same results and the same bytes for the same seed
(``tests/test_torch_observe.py`` holds them equal).

The engine's flight recorder and its phase profiler are strictly
per-rank: every engine can answer "what happened HERE", but nobody in
the fleet can see the fleet. This package closes that gap with the
paper's own machinery — no scrape endpoint, no metrics sidecar, no
designated collector rank:

  - :class:`TelemetryPlane` — each rank periodically emits a compact
    delta-encoded digest of its engine telemetry (``wire.encode_telem``,
    byte-pinned so the C engine originates the identical bytes) on
    ``Tag.TELEM`` and store-and-forwards foreign digests along the
    existing skip-ring overlay, so ANY rank converges on an
    eventually-consistent :class:`FleetView`.
  - :class:`FleetView` — per-rank last-digest values plus fleet
    rollups, staleness-stamped by membership epoch and digest age.
  - :func:`ledger` / :class:`Ledger` — deterministic per-step cost
    ledgers for every committed collective schedule (who sends what to
    whom at each step, and how many bytes), the "predicted" side of
    rlo-scope's measured-vs-predicted attribution (docs/DESIGN.md §21).
  - :class:`Watchdog` / :class:`Rule` — declarative SLO rules
    (retransmit storms, epoch-lag ceilings, rejoin-cascade rates,
    pickup-backlog growth) evaluated against the fleet view; a
    tripped rule dumps a self-contained incident bundle (per-rank
    trace JSONL, merged Chrome trace, metrics snapshots, the fleet
    view, and the seeded replay recipe).

Everything here is OFF by default and lives entirely outside the
engine hot path: an engine without an attached plane runs zero new
code beyond the always-live plain-int heal-cost counters
(docs/DESIGN.md §7 overhead contract), and the plane itself draws
time only from the engine's injectable clock, so whole instrumented
fleets replay bit-for-bit inside the deterministic simulator.
"""

from rlo_tpu_torch.observe.ledger import (ALGORITHMS, COMPOSITES, SCHEDULES,
                                          Edge, Ledger, LedgerError, Step,
                                          ledger)
from rlo_tpu_torch.observe.remedy import (DEFAULT_ACTIONS, REMEDY_KINDS,
                                          REMEDY_PID_BASE, RemedyPolicy,
                                          RemedyRecord)
from rlo_tpu_torch.observe.spans import STAGE_NAMES, SpanRecorder, Stage
from rlo_tpu_torch.observe.telemetry import (FleetView, TelemetryPlane,
                                             merge_counter_dicts,
                                             merge_histograms)
from rlo_tpu_torch.observe.watchdog import (DEFAULT_RULES, Incident, Rule,
                                            Watchdog, parse_rule)

__all__ = [
    "FleetView", "TelemetryPlane", "merge_counter_dicts",
    "merge_histograms", "Rule", "Watchdog", "Incident", "DEFAULT_RULES",
    "parse_rule", "Stage", "STAGE_NAMES", "SpanRecorder",
    "ALGORITHMS", "COMPOSITES", "SCHEDULES", "Edge", "Ledger",
    "LedgerError", "Step", "ledger",
    "RemedyRecord", "RemedyPolicy", "REMEDY_PID_BASE", "REMEDY_KINDS",
    "DEFAULT_ACTIONS",
]
