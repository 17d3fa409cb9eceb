"""The port's deterministic simulator (``rlo_tpu_torch/transport/sim.py``)
against the JAX package's (``rlo_tpu/transport/sim.py``) on the CPU: the
same seed gives the same result dict key for key in both packages, the
schedule digest, the deliveries, the membership views, the telemetry
and the watchdog's incidents included, and the sweep CLI prints the same
JSON line. Both are pure Python over the standard library, so every
comparison is exact."""

import json
import logging
import subprocess
import sys
from pathlib import Path

import pytest

from rlo_tpu.engine import EngineManager as RefManager
from rlo_tpu.engine import ProgressEngine as RefEngine
from rlo_tpu.transport import sim as ref
from rlo_tpu_torch.engine import EngineManager, ProgressEngine
from rlo_tpu_torch.transport import sim as port

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (0, 1, 2)

logging.getLogger("rlo_tpu").setLevel(logging.ERROR)
logging.getLogger("rlo_tpu_torch").setLevel(logging.ERROR)


def test_same_scenario_kinds():
    assert port.SCENARIO_KINDS == ref.SCENARIO_KINDS
    assert port.FABRIC_SCENARIO_KINDS == ref.FABRIC_SCENARIO_KINDS
    assert port.ALL_SCENARIO_KINDS == ref.ALL_SCENARIO_KINDS


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ref.SCENARIO_KINDS)
def test_protocol_scenario_equals_reference(kind, seed):
    want = ref.make_scenario(kind, seed).run()
    got = port.make_scenario(kind, seed).run()
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key
    for key in ("digest", "delivered", "views"):
        assert key in want


def _telemetry_scenario(sim, seed, tmp):
    """A kill, a restart and traffic under the telemetry plane and a
    watchdog with a rule that trips (an incident bundle per package)."""
    return sim.Scenario(
        world_size=4, seed=seed, duration=90.0,
        script=[(2.0, "bcast", 0), (15.0, "kill", 2), (35.0, "restart", 2),
                (60.0, "bcast", 3)],
        telemetry=True, check_delivery=False,
        watchdog_rules=["sent: sum(sent_bcast) >= 2",
                        "rejoin-cascade: sum(rejoins) / 30s >= 0.5"],
        incident_dir=str(tmp))


@pytest.mark.parametrize("seed", SEEDS)
def test_telemetry_and_incidents_equal_reference(seed, tmp_path):
    want = _telemetry_scenario(ref, seed, tmp_path / "ref").run()
    got = _telemetry_scenario(port, seed, tmp_path / "port").run()
    assert want["telemetry"] and want["incidents"]
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "incidents":
            continue
        assert got[key] == want[key], key
    # an incident names its bundle directory, which is each package's own
    norm = [dict(i, bundle_dir=None) for i in want["incidents"]]
    assert [dict(i, bundle_dir=None) for i in got["incidents"]] == norm


def _hand_world(sim, manager, engine, seed, scheduler):
    """A SimWorld driven by hand: bcasts under loss and duplication, a
    partition and its heal, a kill; returns the digest, the clock and
    every rank's pickups."""
    world = sim.SimWorld(4, seed=seed, drop_p=0.05, dup_p=0.05,
                         scheduler=scheduler)
    mgr = manager()
    engines = [engine(world.transport(r), manager=mgr, clock=world.clock,
                      failure_timeout=6.0, heartbeat_interval=1.0,
                      arq_rto=1.5, arq_max_retries=6, op_deadline=60.0)
               for r in range(4)]
    got = {r: [] for r in range(4)}
    for i in range(6):
        engines[i % 4].bcast(b"m%d" % i)
    killed = parted = False
    while world.now < 40.0:
        if not parted and world.now >= 2.0:
            parted = True
            world.partition([[0, 1], [2, 3]])
        if parted and 3.0 <= world.now < 3.1:
            world.heal()
        if not killed and world.now >= 5.0:
            killed = True
            world.kill_rank(3)
            engines[3].cleanup()
        world.step()
        mgr.progress_all()
        for r in range(3 if killed else 4):
            while (m := engines[r].pickup_next()) is not None:
                got[r].append((m.type, m.origin, m.pid, m.vote, bytes(m.data)))
    out = (world.schedule_digest(), world.now, got)
    for e in engines:
        e.cleanup()
    return out


@pytest.mark.parametrize("scheduler", ("heap", "calendar"))
@pytest.mark.parametrize("seed", SEEDS)
def test_hand_driven_world_equals_reference(seed, scheduler):
    want = _hand_world(ref, RefManager, RefEngine, seed, scheduler)
    assert any(want[2].values())
    assert _hand_world(port, EngineManager, ProgressEngine, seed,
                       scheduler) == want


def test_fuzz_sweep_equals_reference():
    kinds = ("partition", "fabric_kill")
    assert port.fuzz_sweep(range(2), kinds) == ref.fuzz_sweep(range(2), kinds)


def test_cli_prints_the_reference_json(capsys):
    assert ref.main(["--seeds", "2"]) == 0
    want = capsys.readouterr().out
    assert port.main(["--seeds", "2"]) == 0
    got = capsys.readouterr().out
    assert json.loads(want)["ok"] and got == want


def test_cli_module_runs_without_the_reference():
    """``python -m rlo_tpu_torch.transport.sim`` runs the port's sweep,
    loading nothing of the JAX package (its lazy imports included)."""
    code = ("import runpy, sys\n"
            "sys.argv = ['sim', '--seeds', '1', '--kinds', "
            "'partition,churn_weather,fabric_paged,remedy_flap']\n"
            "try:\n"
            "    runpy.run_module('rlo_tpu_torch.transport.sim', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m == 'rlo_tpu' or "
            "m.startswith('rlo_tpu.') or m == 'jax']\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])["runs"] == 4
