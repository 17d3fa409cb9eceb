"""The port stands alone: no module of rlo_tpu_torch, not chip_smoke.py
and not the card-only tests (tests/test_torch_gpu_*.py, which the machine
with the card runs without the JAX package) imports JAX or anything of
the JAX package; importing the port touches no GPU. Its copy of the C
core (rlo_tpu_torch/native) names no path into the JAX package's and
builds only into its git-ignored _build; no file of the port names a
path under /root/."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "rlo_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + \
    sorted((ROOT / "tests").glob("test_torch_gpu_*.py"))

# `rlo_tpu\b` does not match `rlo_tpu_torch` (no word boundary before _)
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+rlo_tpu\b|"
    r"from\s+rlo_tpu\b)|import_module\(\s*['\"](jax|rlo_tpu)\b(?!_torch)",
    re.M)


def test_pattern_catches_what_it_must():
    bad = ["import jax", "from jax import lax", "  import jax.numpy as jnp",
           "import rlo_tpu", "from rlo_tpu.topology import ring_perm",
           "from rlo_tpu import topology",
           "        from rlo_tpu.observe import (DEFAULT_RULES,",
           "    import rlo_tpu.serving.scenario as sc",
           "importlib.import_module('rlo_tpu.pallas')"]
    good = ["import rlo_tpu_torch", "from rlo_tpu_torch.ops import x",
            "import torch", "# the JAX package (rlo_tpu) is the reference"]
    assert all(FORBIDDEN.search(s) for s in bad)
    assert not any(FORBIDDEN.search(s) for s in good)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    assert path.is_file(), path
    hits = [m.group(0) for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def _imported(tree):
    """Every module an ``import``/``from ... import`` statement names,
    at any depth (inside functions, methods, ``try`` and ``if`` blocks),
    and every literal ``importlib.import_module``/``__import__`` name."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"relative import at {node.lineno}"
            out.append((node.lineno, node.module))
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__"):
            out.append((node.lineno, node.args[0].value))
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_import_at_any_depth(path):
    """The syntax tree's view of the same rule: a lazy import inside a
    function (the simulator's, the scenarios', the watchdog's and the
    timeline's) names the port's module, never the JAX package's."""
    hits = [(line, name) for line, name in
            _imported(ast.parse(path.read_text()))
            if name.split(".")[0] in ("jax", "jaxlib", "rlo_tpu")]
    assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_tree_walk_sees_lazy_imports():
    src = ("def f():\n"
           "    if x:\n"
           "        from rlo_tpu.observe import Watchdog\n"
           "    try:\n"
           "        import jax.numpy\n"
           "    except ImportError:\n"
           "        pass\n"
           "    return importlib.import_module('rlo_tpu.workloads')\n")
    assert [n for _, n in _imported(ast.parse(src))] == \
        ["rlo_tpu.observe", "jax.numpy", "rlo_tpu.workloads"]


def test_card_tests_are_scanned():
    """Every card-only test file is jax-free and in SOURCES."""
    gpu = [p.name for p in SOURCES if p.name.startswith("test_torch_gpu_")]
    assert sorted(gpu) == ["test_torch_gpu_bridge.py",
                           "test_torch_gpu_collective_grads.py",
                           "test_torch_gpu_decode.py",
                           "test_torch_gpu_fabric.py",
                           "test_torch_gpu_flash.py",
                           "test_torch_gpu_flash_grad.py",
                           "test_torch_gpu_grid_limits.py",
                           "test_torch_gpu_host_backends.py",
                           "test_torch_gpu_model_parallel_train.py",
                           "test_torch_gpu_moe.py",
                           "test_torch_gpu_paged.py",
                           "test_torch_gpu_parallel.py",
                           "test_torch_gpu_pipeline.py",
                           "test_torch_gpu_reduce.py",
                           "test_torch_gpu_speculative.py"]


def test_importing_every_module_loads_no_reference_module():
    code = (
        "import sys, importlib, pkgutil, rlo_tpu_torch\n"
        "for m in pkgutil.walk_packages(rlo_tpu_torch.__path__, "
        "'rlo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import torch\n"
        "bad = [m for m in sys.modules if m == 'rlo_tpu' "
        "or m.startswith('rlo_tpu.')]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


NATIVE = ROOT / "rlo_tpu_torch" / "native"
#: the C sources, headers, Makefile and launcher of the port's C core
NATIVE_FILES = sorted(p for p in NATIVE.rglob("*")
                      if p.is_file() and "_build" not in p.parts
                      and p.suffix in (".c", ".h", ".supp", "")
                      and "__pycache__" not in p.parts)


def test_native_files_are_the_core():
    names = {str(p.relative_to(NATIVE)) for p in NATIVE_FILES}
    assert {"Makefile", "tcprun", "tsan.supp", "rlo_core.h",
            "rlo_internal.h", "rlo_engine.c", "rlo_coll.c",
            "femtompi/femtompi.c", "femtompi/mpi.h", "femtompi/mpirun.c",
            "mock_mpi/mpi.h"} <= names


@pytest.mark.parametrize("path", NATIVE_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_native_names_no_path_into_the_jax_package(path):
    """No #include, -I, Makefile path or comment of the port's C core
    reaches into rlo_tpu/ (``rlo_tpu/`` does not match ``rlo_tpu_torch/``
    thanks to the boundary), and nothing climbs out of the directory."""
    text = path.read_text()
    hits = re.findall(r"\brlo_tpu/|rlo_tpu\.native|\.\./|/root/", text)
    assert not hits, f"{path.relative_to(ROOT)} names {hits}"
    for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
        assert (path.parent / inc).is_file(), inc


def test_no_file_of_the_port_names_a_path_under_root():
    files = [p for p in (ROOT / "rlo_tpu_torch").rglob("*")
             if p.is_file() and "_build" not in p.parts
             and "__pycache__" not in p.parts] + [ROOT / "chip_smoke.py"]
    hits = [str(p.relative_to(ROOT)) for p in files
            if "/root/" in p.read_text(errors="replace")]
    assert not hits


def test_native_build_writes_only_under_its_ignored_directory():
    """Building the library and every tool adds no file beside the
    sources: everything lands in native/_build, which .gitignore lists."""
    assert "rlo_tpu_torch/native/_build/" in \
        (ROOT / ".gitignore").read_text().splitlines()

    def outside():
        return {p for p in NATIVE.rglob("*")
                if "_build" not in p.parts and "__pycache__" not in p.parts}
    before = outside()
    out = subprocess.run(
        [sys.executable, "-m", "rlo_tpu_torch.native.build", "lib",
         "femtompirun", "demo"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    built = [Path(line) for line in out.stdout.split()]
    assert len(built) == 3 and all(
        p.is_file() and p.parent == NATIVE / "_build" for p in built)
    assert outside() == before


#: a repo path the tools may read: directories end in '/', files carry
#: a source or data extension
_PATH_CONST = re.compile(
    r"^[\w.-]+(/[\w.-]+)*/([\w.-]+\.(py|c|h|cu|cuh|json|jsonl|md))?$")
TOOLS = sorted((ROOT / "rlo_tpu_torch" / "tools").glob("*.py"))


def _path_constants(path):
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _PATH_CONST.match(node.value):
            out.append((node.lineno, node.value))
    return out


def test_path_pattern_catches_what_it_must():
    assert all(_PATH_CONST.match(s) for s in (
        "rlo_tpu/engine.py", "rlo_tpu/pallas/decode.py",
        "rlo_tpu_torch/kernels/csrc/decode.cu", "rlo_tpu/tools/",
        "rlo_tpu/native/rlo_core.h"))
    assert not any(_PATH_CONST.match(s) for s in (
        "GB/s", "bytes/edge", "xor_perm/involution",
        "models/serve.py DecodeServer page_size default"))


@pytest.mark.parametrize("path", TOOLS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_tools_read_only_the_port(path):
    """Every path constant of the port's tools names a file of the port:
    a tool that quietly analysed the JAX package would pass every parity
    test against it."""
    bad = [(ln, s) for ln, s in _path_constants(path)
           if not s.startswith("rlo_tpu_torch/")]
    assert not bad, f"{path.relative_to(ROOT)}: {bad}"


def test_the_analyzers_name_their_inputs():
    """The check above is not vacuous: the four analyzers name dozens of
    the port's files, and the kernel sources among them."""
    consts = {s for p in TOOLS for _ln, s in _path_constants(p)}
    assert len(consts) >= 40
    assert {"rlo_tpu_torch/kernels/csrc/decode.cu",
            "rlo_tpu_torch/native/rlo_engine.c",
            "rlo_tpu_torch/topology.py"} <= consts
