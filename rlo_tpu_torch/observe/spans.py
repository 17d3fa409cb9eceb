"""Request-scoped causal spans (docs/DESIGN.md §19).

The port's own copy of ``rlo_tpu/observe/spans.py``, line for line: only
the imports and the logger names differ, so both packages give the same
results and the same bytes for the same seed
(``tests/test_torch_observe.py`` holds them equal).

The fleet telescope (§17) answers "what is the fleet doing" with
counters; this module answers "where did THIS request's latency go".
A sampled request carries a compact span context in-band — appended as
a trailer to the fabric records that already cross ranks
(wire.encode_span_ctx) — and every rank that moves the request through
a stage boundary emits an ``Ev.SPAN`` event into the engine tracer ring:

  stage taxonomy (one span per boundary, duration = stage time):
    admit_bcast    gateway submit -> this rank applied the ADMIT record
    placement_iar  IAR placement round propose -> adopt (fleet-level,
                   keyed rid = (-1, placement version))
    queue          owner enqueue -> the decode round that first ran it
    prefill_chunk  one paged prefill chunk (DecodeServer scheduler)
    decode_round   first decode round -> completion at the owner
    requeue        failover: a surviving rank re-queues a dead owner's
                   request (zero-duration marker; the re-queued
                   request's next queue span starts here, which is the
                   lineage link back to the dead owner's last stage)
    deliver        owner DONE broadcast -> gateway delivery

Sampling is deterministic and order-independent: ``trace_sample=1/N``
selects rids by a keyed hash (crc32 over a seed-derived salt and the
rid), so every rank — and every re-run of the same seed — picks the
SAME rid set with no coordination and no per-request rng draws
(R5-clean: the one ``Random(seed)`` lives in ``__init__``).

The disabled path is the established one-branch contract: a fabric
without a recorder attached stamps no trailers (record bytes are
byte-identical to the pre-span wire format) and runs one ``is None``
test per instrumentation site; the tracer itself keeps its one
``enabled`` branch.  Span timestamps come from the engine's injectable
clock, so traced fleets replay bit-for-bit in the simulator.
"""

from __future__ import annotations

import struct
import zlib
from enum import IntEnum
from random import Random
from typing import Callable, Optional, Tuple

from rlo_tpu_torch.utils.tracing import TRACER, Ev, Tracer
from rlo_tpu_torch.wire import SPAN_F_SAMPLED, encode_span_ctx

Rid = Tuple[int, int]


class Stage(IntEnum):
    """Stage ids carried in the span-context trailer (u8) and the
    Ev.SPAN ``a`` field — shared numbering with the analyzer
    (tools/rlo_trace.py) and the timeline renderer."""
    ADMIT_BCAST = 1
    PLACEMENT_IAR = 2
    QUEUE = 3
    PREFILL_CHUNK = 4
    DECODE_ROUND = 5
    REQUEUE = 6
    DELIVER = 7


#: stage id -> lowercase name (the analyzer/report vocabulary)
STAGE_NAMES = {int(s): s.name.lower() for s in Stage}


class SpanRecorder:
    """Per-rank span emitter: owns the sampling decision and turns
    (rid, stage, start, end) into Ev.SPAN tracer events stamped on the
    engine clock. One recorder per fabric rank; a fleet shares the
    seed so every rank samples the same rid set."""

    def __init__(self, rank: int, clock: Callable[[], float],
                 sample: int = 1, seed: int = 0,
                 tracer: Optional[Tracer] = None):
        self.rank = rank
        self.clock = clock
        self.sample_n = max(1, int(sample))
        # one construction-time draw (R5: instance rng, no global
        # seeding) — the salt keys the per-rid hash so different seeds
        # sample different rid sets
        self._salt = Random(seed).getrandbits(32)
        self.tracer = TRACER if tracer is None else tracer

    def sampled(self, rid: Rid) -> bool:
        """Deterministic, order-independent 1/N selection: same seed
        => same sampled rid set, on every rank, in every re-run."""
        if self.sample_n <= 1:
            return True
        h = zlib.crc32(struct.pack("<Iqq", self._salt,
                                   rid[0], rid[1]))
        return h % self.sample_n == 0

    def ctx(self, rid: Rid, stage: int, t: float,
            sampled: bool = True) -> bytes:
        """Encode the in-band trailer for a record leaving this rank;
        ``t`` is the stage START on the engine clock (seconds)."""
        return encode_span_ctx(rid[0], rid[1], stage,
                               int(round(t * 1e6)),
                               SPAN_F_SAMPLED if sampled else 0)

    def emit(self, rid: Rid, stage: int, t_start: float,
             t_end: float) -> None:
        """One stage-boundary span: [t_start, t_end] on the engine
        clock (seconds). The event timestamp is the stage END; the
        duration rides in ``b`` (usec, clamped to int32)."""
        end_usec = int(round(t_end * 1e6))
        dur = max(0, end_usec - int(round(t_start * 1e6)))
        self.tracer.emit(self.rank, Ev.SPAN, int(stage),
                         min(dur, 0x7FFFFFFF), rid[1], rid[0],
                         ts_usec=end_usec)
