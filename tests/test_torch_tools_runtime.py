"""The port's runtime tools (rlo-scope, rlo-top, rlo-trace, perf-gate)
held against the JAX package's: the same command line gives the same
exit code and the same ``--json`` report once the package name is taken
out of it. The tools run in this process through their ``main(argv)``;
each reads only its own package's modules.
"""

from __future__ import annotations

import copy
import importlib
import json

import numpy as np
import pytest

PKGS = ("rlo_tpu", "rlo_tpu_torch")


def _run(capsys, pkg: str, tool: str, argv):
    rc = importlib.import_module(f"{pkg}.tools.{tool}").main(list(argv))
    out = capsys.readouterr().out
    return rc, out.replace("rlo_tpu_torch", "rlo_tpu")


def _both(capsys, tool: str, argv):
    got = {pkg: _run(capsys, pkg, tool, argv) for pkg in PKGS}
    assert got["rlo_tpu_torch"] == got["rlo_tpu"]
    return got["rlo_tpu"]


@pytest.mark.parametrize("argv", [
    ["--schedule", "ring_allreduce", "--n", "8", "--seed", "0"],
    ["--schedule", "recursive_doubling", "--n", "8", "--seed", "0"],
    ["--schedule", "ring_allreduce", "--n", "5", "--seed", "3",
     "--nbytes", "65540"],
], ids=["ring8", "rd8", "ring5"])
def test_rlo_scope_sim_report(capsys, argv):
    rc, out = _both(capsys, "rlo_scope", argv + ["--json"])
    doc = json.loads(out)
    assert rc == 0 and doc["findings"] == []
    assert doc["measured"]["coll_bytes"] == \
        [doc["ledger"]["bytes_per_rank"]] * doc["n"]


def test_rlo_scope_text_mode(capsys):
    rc, out = _both(capsys, "rlo_scope",
                    ["--schedule", "recursive_doubling", "--n", "4"])
    assert rc == 0 and "recursive_doubling:1" in out


def test_rlo_top_snapshot(capsys):
    rc, out = _both(capsys, "rlo_top",
                    ["--ranks", "8", "--vtime", "12", "--json"])
    doc = json.loads(out)
    assert rc == 0 and doc["ok"] and doc["fleet"]["present"] == 8


def test_rlo_top_fabric_serving_frames(capsys):
    rc, out = _both(capsys, "rlo_top",
                    ["--ranks", "4", "--vtime", "6", "--serve"])
    assert rc == 0 and "rank" in out


def test_rlo_trace_fabric_kill(capsys):
    rc, out = _both(capsys, "rlo_trace",
                    ["--scenario", "fabric_kill", "--seed", "7",
                     "--world-size", "8", "--json"])
    doc = json.loads(out)
    assert rc == 0 and doc["findings"] == [] and doc["failover"]


def test_rlo_trace_request_waterfall(capsys):
    rc, out = _both(capsys, "rlo_trace",
                    ["--scenario", "fabric_kill", "--seed", "7",
                     "--world-size", "8", "--request", "1:0"])
    assert rc == 0 and "1:0" in out


def _doc(**metrics):
    return {"suite": "engine_bench", "schema": 1, "quick": True,
            "config": {"payload": 256}, "metrics": copy.deepcopy(metrics)}


def _m(value, direction="higher", tolerance=None):
    return {"value": value, "direction": direction, "tolerance": tolerance}


_BASE = _doc(frames=_m(96, "exact"),
             rate=_m(1000.0, "higher", {"factor": 5.0}),
             p99=_m(100.0, "lower", {"rel": 0.1}),
             gap=_m(3.0, "lower", {"abs": 0.5}),
             info=_m(7.0))


@pytest.mark.parametrize("fresh,want_rc", [
    (_BASE, 0),
    (dict(_BASE, metrics=dict(_BASE["metrics"], frames=_m(97, "exact"),
                              rate=_m(150.0), p99=_m(120.0, "lower"),
                              gap=_m(3.6, "lower"), info=_m(1.0))), 1),
    (dict(_BASE, metrics={k: v for k, v in _BASE["metrics"].items()
                          if k != "gap"}), 1),
    (dict(_BASE, suite="sim_bench"), 2),
], ids=["clean", "regressions", "missing_metric", "suite_mismatch"])
def test_perf_gate_same_verdict(capsys, tmp_path, fresh, want_rc):
    base_p, fresh_p = tmp_path / "base.json", tmp_path / "fresh.json"
    base_p.write_text(json.dumps(_BASE))
    fresh_p.write_text(json.dumps(fresh))
    argv = ["--baseline", str(base_p), "--fresh", str(fresh_p),
            "--report"]
    got = {}
    for pkg in PKGS:
        rc = importlib.import_module(f"{pkg}.tools.perf_gate").main(argv)
        cap = capsys.readouterr()
        got[pkg] = (rc, cap.out, cap.err.replace("rlo_tpu_torch",
                                                 "rlo_tpu"))
    assert got["rlo_tpu_torch"] == got["rlo_tpu"]
    assert got["rlo_tpu"][0] == want_rc


def _ring_dumps(pkg: str, tmp_path, n: int = 8, nbytes: int = 4096):
    """Per-rank tracer dumps of an instrumented ring allreduce over the
    package's loopback world, timed by a counting clock (every reading
    one millisecond later), so both packages' dumps can be compared."""
    coll = importlib.import_module(f"{pkg}.ops.collectives")
    loopback = importlib.import_module(f"{pkg}.transport.loopback")
    tracing = importlib.import_module(f"{pkg}.utils.tracing")
    ticks = iter(range(1, 1 << 30))
    clock = lambda: next(ticks) * 1e-3  # noqa: E731
    world = loopback.LoopbackWorld(n)
    tracer = tracing.Tracer(enabled=True)
    comms = [coll.Comm(world.transport(r)) for r in range(n)]
    for c in comms:
        c.instrument(clock, tracer)
    xs = [np.full(nbytes // 4, float(r + 1), np.float32) for r in range(n)]
    out = coll.run_collectives([c.allreduce(x, algorithm="ring")
                                for c, x in zip(comms, xs)])
    assert all(np.all(o == n * (n + 1) / 2) for o in out)
    paths = []
    for r in range(n):
        p = tmp_path / f"{pkg}.rank{r}.jsonl"
        assert tracer.dump_jsonl(str(p), rank=r) > 0
        paths.append(str(p))
    return paths


def test_rlo_scope_dump_mode(capsys, tmp_path):
    """Dumps of the port's Comm equal the JAX package's line for line,
    and both tools' reports over them are the same and clean."""
    dumps = {pkg: _ring_dumps(pkg, tmp_path) for pkg in PKGS}
    for a, b in zip(dumps["rlo_tpu"], dumps["rlo_tpu_torch"]):
        assert open(a).read() == open(b).read()
    argv = dumps["rlo_tpu_torch"] + ["--nbytes", "4096", "--json"]
    rc, out = _both(capsys, "rlo_scope", argv)
    doc = json.loads(out)
    assert rc == 0 and doc["findings"] == []
    assert doc["schedule"] == "ring_allreduce" and doc["n"] == 8
    assert all(row["gbps_med"] for row in doc["steps"])
    # joined against another schedule, the dumps' steps are not in its
    # ledger: a finding, the same in both tools
    rc, out = _both(capsys, "rlo_scope", dumps["rlo_tpu_torch"] + [
        "--schedule", "recursive_doubling", "--json"])
    assert rc == 1 and json.loads(out)["findings"]
