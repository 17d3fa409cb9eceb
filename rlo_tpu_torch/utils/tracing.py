"""Structured per-op event tracing and ``torch.profiler`` integration.

The port of ``rlo_tpu/utils/tracing.py``:

  - ``Ev``, ``Event``, ``Tracer`` and the process-wide ``TRACER`` are
    copies of the JAX package's (same event numbering and field
    semantics): the port's progress engine emits into this ``TRACER``,
    and one scenario gives the same event stream in both packages but
    for the wall-clock ``ts_usec``;
  - device side: ``annotate(name)`` names a range: an NVTX range once
    CUDA is up and, only while a ``torch.profiler`` records, a
    ``record_function`` range, so the work launched inside it shows up
    under that name in a profile, and the stream time of its path in
    ``DEVICE_SPANS``; ``profile(logdir)`` is a ``torch.profiler``
    capture window (CPU, and CUDA where there is a card) that writes a
    Chrome trace into ``logdir``.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Callable, Deque, Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler


class Ev(IntEnum):
    """Event kinds — numbering AND field semantics shared with the C
    core (rlo_core.h enum rlo_ev). ``c``/``d`` carry the correlation
    identity the cross-rank timeline merger keys on: for store-and-
    forward frames the identity is (origin, seq) for Tag.BCAST —
    every initiated broadcast is stamped with a per-origin sequence
    number — and (origin, pid) for IAR/FAILURE/ABORT traffic; ``d``
    is the immediate sender, which is what turns per-rank event logs
    into send->recv flow edges (rlo_tpu/utils/timeline.py)."""
    BCAST_INIT = 1      # a = tag, b = payload len, c = seq (BCAST) / pid
    BCAST_FWD = 2       # receipt+forward step of a store-and-forward
    #                     frame: a = tag, b = origin, c = seq/pid,
    #                     d = immediate sender (emitted even for leaf
    #                     receipts with zero forward targets)
    DELIVER = 3         # a = tag, b = origin, c = seq/pid, d = sender
    PROPOSAL_SUBMIT = 4  # a = pid, c = round generation
    JUDGE = 5           # a = pid, b = verdict
    VOTE = 6            # a = pid, b = merged vote, c = generation
    DECISION = 7        # a = pid, b = decision, c = generation
    DRAIN = 8           # a = spins
    HEARTBEAT = 9       # a = destination rank
    FAILURE = 10        # a = failed rank, b = 1 local detection /
    #                     0 learned; c = last-seen heartbeat age (usec,
    #                     clamped to int32) on local detections
    ARQ_GIVEUP = 11     # ARQ exhausted its retries at a live peer and
    #                     the peer is being declared failed: a = peer,
    #                     b = retransmit count of the abandoned frame
    JOIN = 12           # membership probe: a = peer, b = 1 sent /
    #                     0 received, c = incarnation, d = epoch
    ADMIT = 13          # membership admission executed: a = joiner,
    #                     b = new epoch, c = joiner incarnation
    PHASE = 14          # phase-profiler stage sample (docs/DESIGN.md
    #                     §10): a = phase index in the
    #                     metrics.ENGINE_PHASE_KEYS snapshot order,
    #                     b = duration (usec, clamped to int32); the
    #                     timeline merger renders it as a Chrome
    #                     duration slice ENDING at ts_usec
    SPAN = 15           # request-scoped causal span (docs/DESIGN.md
    #                     §19): a = stage id (observe.spans.Stage),
    #                     b = stage duration (usec, clamped to int32;
    #                     -1 marks a wire-hop receipt of a span-stamped
    #                     record rather than a stage boundary),
    #                     c = rid seq, d = rid gateway. Emitted with an
    #                     explicit engine-clock ts_usec (stage END) so
    #                     traced fleets replay bit-for-bit in the
    #                     deterministic simulator
    STEP = 16           # collective data-plane step (docs/DESIGN.md
    #                     §21): a = schedule id (observe.ledger
    #                     .ALGORITHMS index), b = step duration (usec,
    #                     clamped to int32) measured completion-to-
    #                     completion at this rank, c = op id * 1024 +
    #                     step index (the cross-rank join identity —
    #                     SPMD ranks issue ops in identical order),
    #                     d = the rank this step RECEIVED from (-1 for
    #                     send-only steps). Emitted at step END with an
    #                     explicit injectable-clock ts_usec; payload
    #                     bytes are deliberately NOT in the event —
    #                     rlo-scope joins them from the cost ledger,
    #                     which instrumentation can therefore never
    #                     contradict silently


@dataclass
class Event:
    ts_usec: int
    rank: int
    kind: Ev
    a: int = 0
    b: int = 0
    c: int = 0
    d: int = 0

    def to_dict(self) -> Dict:
        return {"ts_usec": self.ts_usec, "rank": self.rank,
                "kind": self.kind.name, "a": self.a, "b": self.b,
                "c": self.c, "d": self.d}


@dataclass
class Tracer:
    """Bounded structured event log; disabled by default."""
    capacity: int = 65536
    enabled: bool = False
    _events: Deque[Event] = field(default_factory=deque)
    dropped: int = 0

    def emit(self, rank: int, kind: Ev, a: int = 0, b: int = 0,
             c: int = 0, d: int = 0,
             ts_usec: Optional[int] = None) -> None:
        """``ts_usec`` overrides the wall-clock stamp — span emitters
        pass the engine's injectable clock so traced runs stay
        deterministic under the simulator (R5)."""
        if not self.enabled:
            return
        if len(self._events) >= self.capacity:
            self._events.popleft()
            self.dropped += 1
        self._events.append(
            Event(int(time.time() * 1e6) if ts_usec is None else ts_usec,
                  rank, kind, a, b, c, d))

    def events(self, kind: Optional[Ev] = None,
               rank: Optional[int] = None) -> List[Event]:
        return [e for e in self._events
                if (kind is None or e.kind == kind)
                and (rank is None or e.rank == rank)]

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0

    def dump_jsonl(self, path: str, rank: Optional[int] = None) -> int:
        """Write events as JSON lines; ``rank`` filters to one rank's
        events (the per-rank dump shape rlo_tpu/utils/timeline.py
        merges — in multi-process deployments each process dumps its
        own ranks)."""
        n = 0
        with open(path, "w") as f:
            for e in self._events:
                if rank is not None and e.rank != rank:
                    continue
                f.write(json.dumps(e.to_dict()) + "\n")
                n += 1
        return n

    @contextlib.contextmanager
    def enable(self) -> Iterator["Tracer"]:
        prev = self.enabled
        self.enabled = True
        try:
            yield self
        finally:
            self.enabled = prev


#: default process-wide tracer the engines emit into
TRACER = Tracer()


# ---------------------------------------------------------------------------
# Device-side: torch.profiler hooks
# ---------------------------------------------------------------------------

class DeviceSpans:
    """The stream time of every ``annotate`` range closed while a
    ``torch.profiler`` recorded and CUDA was up, by path.

    A range takes a CUDA event on the current stream where it opens and
    where it closes, so its time is the stream's between the two: the
    work launched inside it, and the device's idle gaps there. Its path
    is the names of the ranges its own thread holds open, outermost
    first: autograd's device thread runs the backward's work, remat's
    recompute with it, while the main thread holds
    ``rlo.train.backward``, so a recompute's path starts at
    ``rlo.train.recompute`` and its time is also inside the backward's.
    A closed range is folded into the totals as soon as the device has
    passed its end, so a process that profiles and never reads keeps no
    more than the ranges in flight. ``event`` makes an event (a test's
    fake on the CPU)."""

    def __init__(self, event: Optional[Callable] = None):
        self._event = event or (lambda: torch.cuda.Event(enable_timing=True))
        self._lock = threading.Lock()
        self._local = threading.local()
        self._pending: Deque[Tuple[str, object, object]] = deque()
        self._totals: Dict[str, Tuple[float, int]] = {}

    @contextlib.contextmanager
    def timed(self, name: str):
        stack = self._local.__dict__.setdefault("stack", [])
        stack.append(name)
        path = "/".join(stack)
        start = self._event()
        start.record()
        try:
            yield
        finally:
            end = self._event()
            end.record()
            stack.pop()
            with self._lock:
                self._pending.append((path, start, end))
                self._fold(wait=False)

    def _fold(self, wait: bool) -> None:
        """Move the closed ranges the device has finished, oldest first,
        into the totals (all of them, waiting, with ``wait``)."""
        while self._pending:
            path, start, end = self._pending[0]
            if wait:
                end.synchronize()
            elif not (start.query() and end.query()):
                return
            self._pending.popleft()
            secs, n = self._totals.get(path, (0.0, 0))
            self._totals[path] = (secs + start.elapsed_time(end) * 1e-3,
                                  n + 1)

    def totals(self) -> Dict[str, Tuple[float, int]]:
        """{path: (stream seconds, ranges)} over every range closed so
        far in the process; waits for the device to reach their ends."""
        with self._lock:
            self._fold(wait=True)
            return dict(self._totals)


#: the stream time of the process's ``annotate`` ranges under a profiler
DEVICE_SPANS = DeviceSpans()


class annotate:
    """Named range around device work: an NVTX range while CUDA is
    initialised (for tools that read NVTX) and, only while a
    ``torch.profiler`` records, a ``record_function`` range in its
    trace and, with CUDA up, the range's stream time in
    ``DEVICE_SPANS``. Outside a profile it costs a flag test and the
    NVTX push and pop, called directly."""

    __slots__ = ("name", "_nvtx", "_profiled")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._nvtx = torch.cuda.is_initialized()
        self._profiled = None
        if _autograd_profiler._is_profiler_enabled:
            stack = contextlib.ExitStack()
            stack.enter_context(torch.profiler.record_function(self.name))
            if self._nvtx:
                stack.enter_context(DEVICE_SPANS.timed(self.name))
            self._profiled = stack
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._profiled is not None:
            self._profiled.__exit__(*exc)
        return False


@contextlib.contextmanager
def profile(logdir: str):
    """Capture a ``torch.profiler`` window (CPU activity, and CUDA where
    a card is present) and write it into ``logdir`` as a Chrome trace,
    ``trace.json``. Yields the profiler, whose ``key_averages()`` and
    ``events()`` the caller may read after the window."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
