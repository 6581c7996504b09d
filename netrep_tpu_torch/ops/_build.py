"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library in the kernel-library
store (:mod:`netrep_tpu_torch.utils.aot`: ``build/netrep_tpu_torch/`` at
the root of the checkout unless ``NETREP_AOT_STORE`` names another), at
first use. The library's file name carries a hash of its source and
flags, so an edited source is rebuilt; an unchanged one is loaded as it is
when its sidecar names this process's environment, and rebuilt in place
otherwise. Builds hold the store's lock, so processes booting together
compile each source once. Libraries are loaded with :mod:`ctypes`; the
wrappers declare every argument type.

Nothing here runs at import: the CPU tests import every module of the port,
and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import ExitStack
from pathlib import Path

from ..utils import aot

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: every kernel source of the port, built together by :func:`build`
SOURCES = ("fused_stats", "fused_gather", "ring_shift")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: per-source record of this process: library path, seconds spent
#: compiling (0.0 when the store had it), ptxas's report and the source
#: of the acquisition (``jit``: compiled here; ``aot``: from the store)
BUILD_INFO: dict[str, dict] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.RLock()


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
    """Where the store keeps ``csrc/<name>.cu``'s library (no environment
    is read: a process without a card may ask)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return aot.store_dir() / f"lib{name}_{digest[:16]}.so"


def _have(name: str, out: Path, env: str, quiet: bool = False) -> bool:
    """The store holds ``name``'s library for ``env``: recorded as this
    process's ``aot`` acquisition unless it already was."""
    if not aot.check_entry(name, out, env, quiet):
        return False
    if BUILD_INFO.get(name, {}).get("lib") != str(out):
        BUILD_INFO[name] = {"lib": str(out), "seconds": 0.0, "ptxas": "",
                            "source": "aot"}
    return True


def build(names) -> None:
    """Make sure the store holds a library of every named source for this
    environment: compile the missing ones, one ``nvcc`` per source, all
    started together, under each source's lock (taken in sorted order, so
    two processes never wait on each other); raise with the compiler's
    output if any fails."""
    nvcc = _nvcc()
    env = aot.env_signature(nvcc)
    todo = {n: library_path(n) for n in sorted(set(names))}
    with _LOAD_LOCK, ExitStack() as locks:
        jobs = {}
        for name, out in todo.items():
            if _have(name, out, env):
                continue
            locks.enter_context(aot.build_lock(out))
            if _have(name, out, env, quiet=True):   # built meanwhile
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, t0) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
                continue
            seconds = time.perf_counter() - t0
            os.replace(tmp, out)
            aot.write_meta(out, name, env, seconds)
            BUILD_INFO[name] = {"lib": str(out), "seconds": seconds,
                                "ptxas": log, "source": "jit"}
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    if jobs:
        aot.gc(keep=[library_path(n) for n in set(_LIBS) | set(todo)])


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use. A
    library the loader refuses is quarantined and rebuilt once; a rebuilt
    library it refuses raises."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        for attempt in (0, 1):
            build([name])
            path = library_path(name)
            try:
                lib = ctypes.CDLL(str(path))
                break
            except OSError as e:
                if attempt or BUILD_INFO[name]["source"] == "jit":
                    raise RuntimeError(
                        f"kernel library {path} does not load: {e}") from e
                aot.quarantine(name, path, f"{type(e).__name__}: {e}")
                BUILD_INFO.pop(name, None)
        aot.touch(path)
        aot.record(name, BUILD_INFO[name]["source"], path)
        _LIBS[name] = lib
    return lib


def load_all() -> dict:
    """Build every source (together) and load each library: per library
    its acquisition ``source``, ``nvcc`` seconds and load seconds."""
    build(SOURCES)
    out = {}
    for name in SOURCES:
        t0 = time.perf_counter()
        load(name)
        info = BUILD_INFO[name]
        out[name] = {"source": info["source"], "nvcc_s": info["seconds"],
                     "load_s": time.perf_counter() - t0}
    return out
