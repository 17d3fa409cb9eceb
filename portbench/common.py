"""What every part of the harness shares: the files found by name, seeds,
the JAX guard and the device line.

The harness is driven by data. ``BENCHMARK.json`` at the checkout's root
names the cells; each cell names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``), and the mix names the driver
that runs it (``drivers/<name>.py``) and the generator of its inputs
(``generators/<name>.py``); a cell's correctness limits sit in
``limits/<cell>.json``, and each metric is a reader of its own,
``metrics/<metric>.py``. Every one is found by its name, so a new cell,
mix, driver, generator or metric is new files and entries. Nothing here
knows a cell by name.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that may not be loaded in a measured process:
#: JAX itself, its libraries, and the JAX package the port was made from
#: (compared whole: ``rlo_tpu_torch`` is not ``rlo_tpu``)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "rlo_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    for w in benchmark(root)["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, base: Path = HERE) -> dict:
    return load_json(base / "configs" / f"{name}.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return load_json(base / "traffic" / f"{name}.json")


def limits(workload: str, base: Path = HERE) -> dict:
    return load_json(base / "limits" / f"{workload}.json")


def module(folder: str, name: str, base: Path = HERE):
    """The module in ``<folder>/<name>.py``, loaded from its file (a
    metric's name has dots, so it is no import path)."""
    path = base / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py under {base}")
    key = "".join(c if c.isalnum() else "_" for c in f"{folder}_{name}")
    spec = importlib.util.spec_from_file_location(f"portbench_{key}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, base: Path = HERE) -> Callable:
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    return module("metrics", name, base).read


def driver(name: str, base: Path = HERE):
    """``drivers/<name>.py``: its ``LIBS`` (the port's kernel libraries
    to build) and ``run(torch, job)``."""
    return module("drivers", name, base)


def generator(name: str, base: Path = HERE):
    """``generators/<name>.py``: its ``inputs(torch, mix, model, seed,
    device)``, the cell's inputs from the seed."""
    return module("generators", name, base)


def metric_specs(workload: str, trace: bool, root: Path = ROOT) -> list:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    (``trace`` False) or the per-layer ones, each kept where its
    ``workloads`` key lists the cell (or has none)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in benchmark(root)[key]
            if workload in m.get("workloads", [workload])]


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each stream of one run (weights, tokens,
    sizes), any whole ``seed`` in, below 2**63 out."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) \
        % (1 << 64)
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) % (1 << 64)
    return (x ^ (x >> 29)) >> 1


def forbidden_loaded() -> list:
    """Forbidden top-level module names present in ``sys.modules``."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)

