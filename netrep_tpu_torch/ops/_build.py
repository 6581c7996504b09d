"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under
``build/netrep_tpu_torch/`` at the root of the checkout, at first use. The
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Libraries are
loaded with :mod:`ctypes`; the wrappers declare every argument type.

Nothing here runs at import: the CPU tests import every module of the port,
and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: every kernel source of the port, built together by :func:`build`
SOURCES = ("fused_stats", "fused_gather", "ring_shift")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "netrep_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: per-source build record of this process: library path, seconds spent
#: compiling (0.0 when an existing library was loaded) and ptxas's report
BUILD_INFO: dict[str, dict] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin); the port's CUDA "
        "kernels are compiled on first use and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names) -> None:
    """Compile every named source that has no library yet, one ``nvcc`` per
    source, all started together; raise with the compiler's output if any
    fails."""
    jobs = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    for name in names:
        out = library_path(name)
        if out.exists():
            BUILD_INFO.setdefault(
                name, {"lib": str(out), "seconds": 0.0, "ptxas": ""}
            )
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_INFO[name] = {
            "lib": str(out), "seconds": time.perf_counter() - t0,
            "ptxas": log,
        }
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
