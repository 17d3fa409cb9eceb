"""Nothing a run loads has the top-level name jax, jaxlib, flax or
rlo_tpu (compared whole: rlo_tpu_torch is the port), and the reference
imports nothing of the port."""

import ast
import json
import subprocess
import sys

from portbench import common

PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from portbench import run, common
import tiny
run.run_cell("sc2-3b-train-4k", 3, 2.0, False, device="cpu",
             overrides=tiny.TRAIN)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax():
    code = PROBE.format(root=str(common.ROOT),
                        tests=str(common.HERE / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, check=True)
    tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert "rlo_tpu_torch" in tops and "portbench" in tops
    assert not set(tops) & set(common.FORBIDDEN_MODULES), tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".", 1)[0] in common.FORBIDDEN_MODULES:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "rlo_tpu_torch_extra", type(sys)("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", type(sys)("x"))
    assert common.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "rlo_tpu.models", type(sys)("x"))
    assert common.forbidden_loaded() == ["rlo_tpu"]


def test_reference_imports_nothing_of_the_port():
    for path in (common.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".", 1)[0] not in (
                    "rlo_tpu_torch", *common.FORBIDDEN_MODULES), (path, n)
