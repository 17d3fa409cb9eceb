"""The port stands alone: no module of rlo_tpu_torch, not chip_smoke.py
and not the card-only tests (tests/test_torch_gpu_*.py, which the machine
with the card runs without the JAX package) imports JAX or anything of
the JAX package; importing the port touches no GPU."""

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


def test_card_tests_are_scanned():
    """Every card-only test file is jax-free and in SOURCES."""
    gpu = [p.name for p in SOURCES if p.name.startswith("test_torch_gpu_")]
    assert sorted(gpu) == ["test_torch_gpu_bridge.py",
                           "test_torch_gpu_decode.py",
                           "test_torch_gpu_flash.py",
                           "test_torch_gpu_flash_grad.py",
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
