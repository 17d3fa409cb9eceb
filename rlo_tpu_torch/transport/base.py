"""Transport interface.

The port's own copy of ``rlo_tpu/transport/base.py``.

The reference hardwires nonblocking MPI point-to-point (MPI_Isend at
rootless_ops.c:1123/1152/1588, MPI_Irecv at :656, MPI_Test at :647) and keeps
an abandoned one-sided RMA experiment (rma_util.c:29-62). Here transports are
pluggable behind a small vtable-style ABC so the progress engine and ops are
transport-agnostic:

  - ``loopback``  — in-process N-rank world (deterministic tests, fuzzing)
  - ``tpu``       — static-schedule lowering to XLA collectives; it does not
                    implement this byte-oriented interface (there is no
                    ANY_SOURCE receive on ICI) but is selected through the
                    same ROOTLESS_BACKEND switch (see rlo_tpu.ops.tpu_collectives)

Semantics mirrored from MPI: per-destination FIFO ordering, nonblocking sends
with completion testing (SendHandle.done ~ MPI_Test on an isend request), and
polling receives of (src, tag, bytes) triples ~ MPI_Irecv(ANY_SOURCE,
ANY_TAG) + MPI_Test + MPI_Status inspection.
"""

from __future__ import annotations

import abc
from typing import Callable, Dict, Optional, Tuple


class SendHandle(abc.ABC):
    """Completion handle for a nonblocking send (~ MPI_Request)."""

    #: True when the send terminated without delivering (peer dead or the
    #: message was dropped by fault injection). ``done()`` still returns
    #: True — the request is no longer in flight, mirroring an MPI send
    #: completing with MPI_ERR_* in its status rather than hanging.
    failed: bool = False

    @abc.abstractmethod
    def done(self) -> bool:
        """Test for completion; must be cheap and non-blocking."""


class CompletedSend(SendHandle):
    """Handle for transports that complete sends synchronously."""

    def done(self) -> bool:
        return True


COMPLETED_SEND = CompletedSend()


class FailedSend(SendHandle):
    """Handle for a send that terminated without delivery."""

    failed = True

    def done(self) -> bool:
        return True


FAILED_SEND = FailedSend()


class Transport(abc.ABC):
    """One rank's endpoint into a communication world."""

    rank: int
    world_size: int

    @abc.abstractmethod
    def isend(self, dst: int, tag: int, data: bytes) -> SendHandle:
        """Nonblocking ordered send of an opaque frame to ``dst``."""

    @abc.abstractmethod
    def poll(self) -> Optional[Tuple[int, int, bytes]]:
        """Return the next delivered (src, tag, data) or None. Non-blocking."""

    def close(self) -> None:  # pragma: no cover - trivial default
        pass


_REGISTRY: Dict[str, Callable] = {}


def register_transport(name: str):
    """Class decorator: register a world factory under ``name`` for the
    ROOTLESS_BACKEND switch (net-new surface required by BASELINE.json)."""
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def make_world(backend: str, world_size: int, **kwargs):
    """Instantiate a transport world by backend name ('loopback', ...)."""
    try:
        factory = _REGISTRY[backend]
    except KeyError:
        raise ValueError(
            f"unknown transport backend {backend!r}; "
            f"registered: {sorted(_REGISTRY)}") from None
    return factory(world_size, **kwargs)
