"""Rootless elastic serving fabric (docs/DESIGN.md §11): a multi-rank
DecodeServer tier scheduled by the paper's own primitives —
rootless-broadcast admission, IAR-consensus placement, failure-machinery
fail-over with exactly-once re-queue. The port's own copy of
``rlo_tpu/serving``, with the same import surface.

Import surface:

  - ``DecodeFabric`` / ``fleet_stats`` — the per-rank fabric node and
    the fleet telemetry rollup (``fabric.py``);
  - ``Placement`` / ``rendezvous_owner`` / ``owner_of`` /
    ``pick_owner`` — the consensus-decided routing records
    (``placement.py``);
  - ``StubBackend`` / ``ModelBackend`` / ``stub_tokens`` — decode
    backends (``backend.py``; ModelBackend puts the port's
    ``models.serve.DecodeServer``, dense or paged, behind the fabric;
    the stubs are the simulator's model-free twins);
  - ``FabricScenario`` / ``make_fabric_scenario`` /
    ``FABRIC_SCENARIO_KINDS`` — deterministic-simulator scenarios
    (``scenario.py``), also reachable through
    ``transport.sim.make_scenario`` / ``fuzz_sweep``;
  - ``pages`` — the page allocator and prefix trie of the paged KV
    cache, shared by the paged server and ``PagedStubBackend``.
"""

from rlo_tpu_torch.serving.backend import (ModelBackend, StubBackend,
                                           stub_tokens)
from rlo_tpu_torch.serving.fabric import (FABRIC_MAGIC, FABRIC_PID_BASE,
                                          DecodeFabric, Rec, fleet_stats)
from rlo_tpu_torch.serving.placement import (Placement, owner_of,
                                             pick_owner, rendezvous_owner)
from rlo_tpu_torch.serving.scenario import (FABRIC_SCENARIO_KINDS,
                                            FabricScenario,
                                            make_fabric_scenario)

__all__ = [
    "DecodeFabric", "fleet_stats", "FABRIC_MAGIC", "FABRIC_PID_BASE",
    "Rec", "Placement", "owner_of", "pick_owner", "rendezvous_owner",
    "ModelBackend", "StubBackend", "stub_tokens", "FabricScenario",
    "make_fabric_scenario", "FABRIC_SCENARIO_KINDS",
]
