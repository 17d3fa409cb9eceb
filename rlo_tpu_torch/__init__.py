"""rlo_tpu_torch: the rootless collectives in PyTorch, for NVIDIA GPUs.

The port of the ``rlo_tpu`` device data plane (rootless broadcast, IAR
consensus, allreduce / reduce-scatter / all-gather / all-to-all,
barrier) from JAX on a TPU to PyTorch on an H100, and of the flagship
transformer's dense serving path (``models``: prefill, KV-cache decode,
``generate`` and the continuous-batching ``DecodeServer``). Their
kernels are CUDA (``kernels/csrc``), built with ``nvcc`` at first use.
The rootless serving fabric schedules fleets of those servers
(``serving``), proven in the deterministic simulator
(``transport.sim``) and watched by the fleet telescope (``observe``).
The host facades (``loopback``, ``native``, ``mpi``, ``tcp``) run the
same op surface on the port's engines, its host collectives
(``ops/collectives.py``) and its copy of the C core (``native``).

    import rlo_tpu_torch
    with rlo_tpu_torch.init(backend="cuda", world_size=8) as b:
        outs = b.allreduce(xs, algorithm="ring")
    with rlo_tpu_torch.init(backend="hybrid", world_size=8) as h:
        decision, outs = h.propose_collective("allreduce", xs, proposer=3)
    with rlo_tpu_torch.init(backend="native", world_size=8) as n:
        outs = n.allreduce(xs)              # the C core's ring, on the host

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise. Importing the package touches no GPU.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["init"]

# On the CPU, torch.exp, log, sin and cos hand MKL's vector math chunks
# of 2048 elements on several threads at once. When a process's first
# such call runs on several threads, one thread's chunk now and then
# comes out less accurate (1.5e-4 relative), which moved the decode
# twin's result 2.5 times past its f32 tolerance. One single-threaded
# call first settles MKL for the rest of the process, for all of them.
torch.exp(torch.zeros(1))


def init(backend: Optional[str] = None, world_size: Optional[int] = None,
         **kwargs):
    """Create a collective facade (``backend.init``). The name comes from
    the argument, then ``$ROOTLESS_BACKEND``, then ``"cuda"``:

    - ``cuda``: every op on the device, ``world_size`` ranks (default 8)
      on one card (``device="cpu"`` runs the plain versions);
    - ``hybrid``: bcast and consensus on the port's progress engines,
      device collectives gated on an IAR round (``bridge.HybridBackend``);
    - ``loopback``, ``native``: the host facades in one process (the
      port's Python engines and ``ops/collectives.py``; the port's copy
      of the C core), numpy or tensors in and the same kind out;
    - ``mpi``, ``tcp``: one process a rank (under femtompirun or
      tcprun), ops take and return this rank's array;
    - ``shm``: raises, pointing at the C demo binary.

    Without a card the default raises; a host facade is only chosen by
    name."""
    from rlo_tpu_torch.backend import init as _init
    return _init(backend, world_size, **kwargs)
