"""On-demand build of the port's copy of the native C core.

Compiles ``librlo_torch_core.so`` from the C sources beside this file the
first time the bindings load it (and whenever a source is newer than the
built library), so a fresh checkout needs no manual make step. Uses the
plain C toolchain only: no MPI, no pybind11 (the bindings are ctypes).

Everything lands in ``_build/`` beside this file (listed in
``.gitignore``): the library, its femtompi-linked variant and the
command-line tools, which ``build_tool`` builds by running the
Makefile's targets, so a build never adds a file that git would
commit. The libraries carry names of their own, distinct from any
other copy of the core a process may load beside them.

    python3 -m rlo_tpu_torch.native.build [lib] [femtompirun] [demo]
                                           [mpidemo] [selftest]

builds what it names (the library when it names nothing) and prints
each path.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR / "_build"
SOURCES = ["rlo_topology.c", "rlo_wire.c", "rlo_trace.c",
           "rlo_world_common.c", "rlo_loopback.c", "rlo_shm.c",
           "rlo_mpi.c", "rlo_tcp.c", "rlo_engine.c", "rlo_coll.c",
           "rlo_bench.c"]
HEADERS = ["rlo_core.h", "rlo_internal.h"]
LIB_NAME = "librlo_torch_core.so"
#: femtompi-linked variant: the MPI transport is live, rendezvous via
#: the femtompirun launcher (env FEMTOMPI_*). Built on demand when a
#: process launched under femtompirun loads the bindings.
MPI_LIB_NAME = "librlo_torch_core_fmpi.so"
_FMPI = ["femtompi/femtompi.c", "femtompi/mpi.h"]


def under_femtompi() -> bool:
    return os.environ.get("FEMTOMPI_RANK") is not None


def lib_path(femtompi: Optional[bool] = None) -> Path:
    if femtompi is None:
        femtompi = under_femtompi()
    return BUILD_DIR / (MPI_LIB_NAME if femtompi else LIB_NAME)


def _stale(out: Path, deps: List[str]) -> bool:
    if not out.exists():
        return True
    mtime = out.stat().st_mtime
    # build.py itself is a dep: changing the source list must trigger
    # a rebuild (a stale lib otherwise masks missing symbols)
    return any((_DIR / f).stat().st_mtime > mtime
               for f in deps + ["build.py"])


def _probe(cc: str, src: str, flag: str) -> bool:
    return subprocess.run([cc, "-xc", "-", flag, "-o", os.devnull],
                          input=src, capture_output=True,
                          text=True).returncode == 0


def _have_mpi(cc: str) -> bool:
    """True when a tiny MPI program compiles AND links — a header-only
    install must not break the whole native-core build with -lmpi."""
    return _probe(cc, "#include <mpi.h>\nint main(void){return "
                  "MPI_Init(0,0);}\n", "-lmpi")


def _have_rt(cc: str) -> bool:
    """shm_open/shm_unlink live in librt on pre-2.34 glibc; a -shared
    link succeeds without it but dlopen then fails with an undefined
    symbol, so probe and link it when present (mirror of the Makefile's
    HAVE_RT)."""
    return _probe(cc, "int main(void){return 0;}\n", "-lrt")


def _compile(out: Path, args: List[str]) -> Path:
    """Run ``cc args -o <private temp>`` and move the result to ``out``
    atomically: xdist workers and the ranks of one launch may all find
    the output stale and build it at the same moment."""
    BUILD_DIR.mkdir(exist_ok=True)
    cc = os.environ.get("CC", "cc")
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    cmd = [cc] + args + ["-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native core build failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build(force: bool = False, femtompi: Optional[bool] = None) -> Path:
    """Build (if needed) and return the shared-library path.

    Under femtompirun (or with ``femtompi=True``, to build it ahead of a
    launch) the femtompi-linked variant is built instead: the MPI
    transport compiles in against femtompi/mpi.h so MpiBackend runs for
    real (one process per rank). Otherwise a real MPI install is
    probed; absent both, rlo_mpi_available() reports 0.
    """
    fmpi = under_femtompi() if femtompi is None else femtompi
    lib = lib_path(fmpi)
    if not force and not _stale(lib, SOURCES + HEADERS
                                + (_FMPI if fmpi else [])):
        return lib
    cc = os.environ.get("CC", "cc")
    srcs = [str(_DIR / s) for s in SOURCES]
    if fmpi:
        extra = ["-DRLO_HAVE_MPI", f"-I{_DIR / 'femtompi'}",
                 str(_DIR / "femtompi" / "femtompi.c")]
    else:
        extra = ["-DRLO_HAVE_MPI", "-lmpi"] if _have_mpi(cc) else []
    if _have_rt(cc):
        extra = extra + ["-lrt"]
    return _compile(lib, ["-O2", "-g", "-std=c11", "-Wall", "-Wextra",
                          "-fPIC", "-shared"] + srcs + extra)


#: the Makefile's tool targets and the file each writes under _build/
TOOLS = {"femtompirun": "femtompirun", "demo": "rlo_demo",
         "mpidemo": "rlo_demo_mpi", "selftest": "rlo_selftest"}


def build_tool(name: str) -> Path:
    """Run the Makefile's ``name`` target, which builds (if needed) into
    ``_build/``, and return the file it writes: ``femtompirun`` (the
    launcher), ``demo`` (the shm scenario runner), ``mpidemo`` (the demo
    linked against femtompi) or ``selftest`` (the core's selftest under
    ASan/UBSan). An exclusive lock keeps xdist workers that want the
    same tool at one moment from writing one file together."""
    if name not in TOOLS:
        raise ValueError(f"unknown tool {name!r}; known: {sorted(TOOLS)}")
    BUILD_DIR.mkdir(exist_ok=True)
    cmd = ["make", "-s", "-C", str(_DIR), name]
    with open(BUILD_DIR / ".make.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native tool build failed ({' '.join(cmd)}):"
                           f"\n{proc.stdout}{proc.stderr}")
    return BUILD_DIR / TOOLS[name]


def main(argv: List[str]) -> int:
    for name in argv or ["lib"]:
        print(build() if name == "lib" else build_tool(name))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
