"""The kernel build's counter, with ``nvcc`` and the loader faked: a
build counts one build and its ``nvcc`` seconds, and loading a library
already built counts a load, not a build."""

import subprocess
import time

from rlo_tpu_torch.kernels import build


def test_build_stats_count_builds_and_loads(monkeypatch, tmp_path):
    runs = []

    def fake_nvcc(cmd, **kw):
        runs.append(cmd)
        time.sleep(0.01)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"lib")
        return subprocess.CompletedProcess(cmd, 0, stdout="")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "find_nvcc", lambda: "/fake/nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_stats", {})
    assert build.build_stats() == {}
    lib = build.load("flash")
    assert build.load("flash") is lib
    st = build.build_stats()
    assert list(st) == ["flash"] and len(runs) == 1
    assert st["flash"]["builds"] == 1 and st["flash"]["loads"] == 1
    assert 0.01 <= st["flash"]["nvcc_s"] < 10
    # a process that finds the library built loads it and builds nothing
    monkeypatch.setattr(build, "_loaded", {})
    build.load("flash")
    st2 = build.build_stats()["flash"]
    assert (st2["builds"], st2["loads"], st2["nvcc_s"]) == \
        (1, 2, st["flash"]["nvcc_s"])
    assert len(runs) == 1
