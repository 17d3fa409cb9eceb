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

    import rlo_tpu_torch
    with rlo_tpu_torch.init(backend="cuda", world_size=8) as b:
        outs = b.allreduce(xs, algorithm="ring")
    with rlo_tpu_torch.init(backend="hybrid", world_size=8) as h:
        decision, outs = h.propose_collective("allreduce", xs, proposer=3)

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


def init(backend: str = "cuda", world_size: int = 8,
         device: Optional[str] = None):
    """Create the collective facade: ``world_size`` ranks on one device
    (``device=None`` is the card; ``"cpu"`` runs the plain versions).
    ``backend="cuda"`` runs every op on the device; ``"hybrid"`` runs
    bcast and consensus on the port's progress engines and gates device
    collectives on an IAR round (``bridge.HybridBackend``)."""
    if backend == "cuda":
        from rlo_tpu_torch.backend import TorchBackend
        return TorchBackend(world_size=world_size, device=device)
    if backend == "hybrid":
        from rlo_tpu_torch.bridge import HybridBackend
        return HybridBackend(world_size=world_size, device=device)
    raise ValueError(f"unknown backend {backend!r}; the port has 'cuda' "
                     f"and 'hybrid'")
