"""The harness finds configurations, mixes, drivers, generators, limits
and metric readers by name, so a later cell, mix, driver, generator or
metric is new files and entries only."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

from portbench import common

BASE = common.HERE


def test_every_name_in_benchmark_has_its_files():
    bench = common.benchmark()
    for c in bench["configs"]:
        assert (common.ROOT / c["file"]).is_file()
        assert common.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        mix = common.traffic(w["traffic"])
        assert callable(common.driver(mix["driver"]).run)
        assert common.driver(mix["driver"]).LIBS
        assert callable(common.generator(mix["generator"]).inputs)
        common.limits(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(common.metric_reader(m["name"]))


def test_dropped_in_files_are_found(tmp_path):
    for sub in ("configs", "traffic", "limits", "metrics", "drivers",
                "generators"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "new-model.json").write_text(
        json.dumps({"name": "new-model", "model": {"vocab": 8}}))
    (tmp_path / "traffic" / "new-mix.json").write_text(
        json.dumps({"driver": "new_driver", "generator": "bursts"}))
    (tmp_path / "limits" / "new-cell.json").write_text(
        json.dumps({"max_gap": 0.5}))
    (tmp_path / "metrics" / "new.layer_metric.py").write_text(
        "def read(ctx):\n    return ctx['x'] * 2\n")
    (tmp_path / "drivers" / "new_driver.py").write_text(
        "LIBS = ('decode',)\n\ndef run(torch, job):\n    return job\n")
    (tmp_path / "generators" / "bursts.py").write_text(
        "def inputs(torch, mix, model, seed, device):\n"
        "    yield from range(seed)\n")
    assert common.config("new-model", tmp_path)["model"]["vocab"] == 8
    mix = common.traffic("new-mix", tmp_path)
    assert common.driver(mix["driver"], tmp_path).LIBS == ("decode",)
    gen = common.generator(mix["generator"], tmp_path)
    assert list(gen.inputs(None, mix, {}, 3, None)) == [0, 1, 2]
    assert common.limits("new-cell", tmp_path)["max_gap"] == 0.5
    assert common.metric_reader("new.layer_metric", tmp_path)({"x": 4}) == 8


def test_metric_specs_follow_workloads_keys(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "end_to_end": [{"name": "a", "workloads": ["c1"]},
                       {"name": "setup_s"}],
        "per_layer": [{"name": "p", "workloads": ["c2"]}, {"name": "q"}]}))
    names = [m["name"] for m in common.metric_specs("c1", False, tmp_path)]
    assert names == ["a", "setup_s"]
    names = [m["name"] for m in common.metric_specs("c1", True, tmp_path)]
    assert names == ["q"]


#: files a later change would add, and nothing else: a configuration, two
#: mixes, a generator that repeats one seeded batch (fed to the existing
#: training driver), a driver and a generator of their own, limits and a
#: metric
NEW_FILES = {
    "configs/tiny-model.json": {
        "name": "tiny-model", "param_dtype": "float32",
        "model": {"vocab": 128, "d_model": 64, "n_heads": 4,
                  "n_kv_heads": 2, "n_layers": 2, "d_ff": 128,
                  "dtype": "float32", "pos_encoding": "rope"}},
    "traffic/repeat-rows.json": {
        "driver": "train", "generator": "repeat_rows", "batch": 2,
        "seq": 32, "checked_steps": 2, "remat": False,
        "optimizer": {"lr": 1e-3, "betas": [0.9, 0.95], "eps": 1e-8,
                      "weight_decay": 0.1}},
    "traffic/countdown.json": {"driver": "tally", "generator": "countdown",
                               "n": 5},
    "limits/tiny-repeat.json": {"loss_gap": 3e-4, "grad_gap": 8e-3,
                                "change_gap": 4e-3},
    "limits/tiny-tally.json": {"sum_gap": 0},
    "generators/repeat_rows.py": """
        def inputs(torch, mix, model, seed, device):
            g = torch.Generator(device=device).manual_seed(seed)
            tok = torch.randint(0, model["vocab"],
                                (mix["batch"], mix["seq"]), generator=g,
                                device=device, dtype=torch.int32)
            while True:
                yield tok.clone()
        """,
    "generators/countdown.py": """
        def inputs(torch, mix, model, seed, device):
            yield from range(mix["n"], 0, -1)
        """,
    "drivers/tally.py": """
        LIBS = ()

        def run(torch, job):
            t = job["traffic"]
            got = sum(job["inputs"](torch, t, job["model"], job["seed"],
                                    job["device"]))
            job["window_closed"]()
            want = t["n"] * (t["n"] + 1) // 2
            return {"ctx": {"kind": "tally", "setup_s": 0.25, "sum": got},
                    "checks": {"checks": {"sum_gap": {
                        "value": abs(got - want),
                        "limit": job["limits"]["sum_gap"]}}},
                    "attempted": t["n"], "failed": 0}
        """,
    "metrics/tally.sum.py": """
        def read(ctx):
            return ctx.get("sum")
        """,
}

PROBE = """
import json, sys
sys.path[:0] = [{copy!r}, {root!r}]
from portbench import run
assert run.__file__.startswith({copy!r}), run.__file__
out = {{w: run.run_cell(w, 11, 0.5, False, device="cpu")
       for w in ("tiny-repeat", "tiny-tally")}}
print(json.dumps({{w: [r["correct"], r["metrics"]] for w, r in out.items()}}))
"""


def test_a_cell_of_new_files_alone_runs(tmp_path):
    """A copy of the harness with the files above added, and entries in
    its BENCHMARK.json, runs both new cells: nothing in it was edited."""
    shutil.copytree(BASE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, body in NEW_FILES.items():
        path = tmp_path / "portbench" / rel
        path.write_text(json.dumps(body) if isinstance(body, dict)
                        else textwrap.dedent(body).lstrip())
    bench = {
        "configs": [{"name": "tiny-model"}],
        "workloads": [
            {"name": "tiny-repeat", "config": "tiny-model",
             "traffic": "repeat-rows", "chips": 1},
            {"name": "tiny-tally", "config": "tiny-model",
             "traffic": "countdown", "chips": 1}],
        "end_to_end": [
            {"name": "train_tokens_per_s", "unit": "tokens/s",
             "workloads": ["tiny-repeat"]},
            {"name": "tally.sum", "unit": "1", "workloads": ["tiny-tally"]},
            {"name": "setup_s", "unit": "s"}],
        "per_layer": []}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = PROBE.format(copy=str(tmp_path), root=str(common.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    ok, metrics = got["tiny-repeat"]
    assert ok and set(metrics) == {"train_tokens_per_s", "setup_s"}
    ok, metrics = got["tiny-tally"]
    assert ok and metrics == {"tally.sum": {"value": 15, "unit": "1"},
                              "setup_s": {"value": 0.25, "unit": "s"}}
