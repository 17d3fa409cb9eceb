"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library lands in ``_build/`` beside this file (listed in
``.gitignore``), named by a hash of its source and flags, so an edited
source rebuilds and an unchanged one loads what is there. Nothing here
runs at import: ``load(name)`` builds on its first call. ``build_stats()``
counts, per library, this process's builds, their ``nvcc`` seconds and
its loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
#: where the CUDA toolkit lives when ``$CUDA_HOME`` does not say
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_name_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, ctypes.CDLL] = {}
#: per library: {"builds", "nvcc_s", "loads"} in this process
_stats: Dict[str, Dict[str, float]] = {}


def _count(name: str, **add) -> None:
    with _lock:
        st = _stats.setdefault(name, {"builds": 0, "nvcc_s": 0.0,
                                      "loads": 0})
        for k, v in add.items():
            st[k] += v


def build_stats() -> Dict[str, Dict[str, float]]:
    """{library: {"builds": nvcc runs, "nvcc_s": their seconds, "loads":
    libraries loaded}} of this process: which kernel was built again,
    and what it cost."""
    with _lock:
        return {k: dict(v) for k, v in _stats.items()}


class KernelBuildError(RuntimeError):
    """A kernel could not be built or loaded (no nvcc, a compile error)."""


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises KernelBuildError when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels build only on a machine with the "
        "CUDA toolkit; CPU tensors use the plain PyTorch versions")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = _lib_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _count(name, builds=1, nvcc_s=time.perf_counter() - t0)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {res.returncode}):\n{res.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed. Thread-safe, and different names build concurrently (one
    ``nvcc`` each); raises KernelBuildError without nvcc."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name not in _loaded:
            if not (CSRC / f"{name}.cu").is_file():
                raise KernelBuildError(f"no kernel source csrc/{name}.cu")
            path = _build(name)
            try:
                _loaded[name] = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(
                    f"cannot load the built kernel library for {name}: "
                    f"{e}") from e
            _count(name, loads=1)
        return _loaded[name]
