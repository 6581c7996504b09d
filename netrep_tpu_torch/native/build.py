"""Build machinery of the native C++ tier.

The port of ``netrep_tpu/native/build.py``: ``netstats.cpp`` is compiled by
the system C++ compiler (``$NETREP_CXX``, default ``g++``) with the same
flags and the same ``-march`` policy into a shared object the first time it
is needed. Where the JAX package caches the object in its package
directory, the port puts it in its kernel-library store
(:mod:`netrep_tpu_torch.utils.aot`: ``build/netrep_tpu_torch/`` at the
root of the checkout unless ``NETREP_AOT_STORE`` names another), as
``libnetstats_<digest>.so``, the digest over the source, the compiler and
the flags, so an edit or a flag change rebuilds. The store's discipline
holds: a sidecar with the host environment
(:func:`~netrep_tpu_torch.utils.aot.host_env_signature`: the compiler's
``--version`` line, the flags, the march; no ``nvcc``, no card), a build
lock, the build into a temporary file renamed into place, quarantine of a
library the loader refuses (``native.load_library``) and a rebuild. A
failed build raises ``RuntimeError`` with the compiler's output; no
compiler and no valid library raises ``RuntimeError`` too. Nothing gives
way to the torch path.

Nothing here runs at import: the compiler is asked when the library is
first needed.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from pathlib import Path

from ..utils import aot

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "netstats.cpp"
#: the library's name in the store and its acquisition log
NAME = "netstats"

#: the JAX package's flags; :func:`cxxflags` adds the ``-march`` level
BASE_FLAGS = (
    "-O3",
    "-std=c++17",
    "-shared",
    "-fPIC",
    "-pthread",
    "-fno-math-errno",
    "-funroll-loops",
)


def cxx() -> str:
    """The compiler: ``$NETREP_CXX``, else ``g++``."""
    return os.environ.get("NETREP_CXX", "g++")


def _default_march() -> str:
    """Arch level of the build. AVX2 (haswell) when the host has it: the
    hot loops (power iteration, gram/degree reductions) are dense double
    FMAs, and AVX2 measured +27% over the flagless baseline on the JAX
    package's bench host — while -march=native (→ cooperlake there)
    measured ~25% SLOWER than AVX2 from its AVX-512 codegen. Hosts without
    AVX2 keep the portable flagless baseline ('' → no -march flag), and
    non-x86 toolchains never see an -march they could reject."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags") and "avx2" in line.split():
                    # haswell == AVX2+FMA, accepted by gcc >= 4.9 and
                    # clang >= 3.6
                    return "haswell"
    except OSError:
        pass
    return ""


def march() -> str:
    """``$NETREP_CXX_MARCH`` (an empty value omits the flag: the portable
    baseline), else :func:`_default_march`."""
    return os.environ.get("NETREP_CXX_MARCH", _default_march())


def cxxflags() -> list[str]:
    m = march()
    return [*BASE_FLAGS, *([f"-march={m}"] if m else [])]


def library_path() -> Path:
    """Where the store keeps the library for this compiler and these
    flags (the JAX package's cache key: source bytes, compiler, flags)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update("\0".join([cxx(), *cxxflags()]).encode())
    return aot.store_dir() / f"lib{NAME}_{h.hexdigest()[:16]}.so"


def toolchain_available() -> bool:
    return aot.cxx_release(cxx()) is not None


def ensure_built() -> tuple[Path, str]:
    """``(path, source)`` of a library valid for this host: ``aot`` when
    the store had it, ``jit`` when it was compiled now (under the build
    lock, into a temporary file renamed into place, with its sidecar).
    Raises ``RuntimeError`` with the compiler's output when the build
    fails, and when there is no compiler and no valid library."""
    lib = library_path()
    release = aot.cxx_release(cxx())
    env = aot.host_env_signature(release, cxxflags(), march())
    if aot.host_entry_ok(lib, env):
        return lib, "aot"
    if release is None:
        raise RuntimeError(
            f"native build impossible: the C++ compiler {cxx()!r} does not "
            f"run (set NETREP_CXX) and the store holds no valid {lib.name}")
    with aot.build_lock(lib):
        if aot.host_entry_ok(lib, env):  # built meanwhile
            return lib, "aot"
        if lib.exists():
            aot.check_entry(NAME, lib, env)  # the miss: event and warning
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [cxx(), *cxxflags(), str(SOURCE), "-o", str(tmp)],
                capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"native build failed ({cxx()} exit {proc.returncode}):"
                    f"\n{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            if tmp.exists():
                tmp.unlink()
        aot.write_meta(lib, NAME, env, time.perf_counter() - t0)
    return lib, "jit"
