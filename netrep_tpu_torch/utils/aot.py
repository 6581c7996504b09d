"""The kernel-library store: where the port keeps what it compiled.

The port of ``netrep_tpu/utils/aot.py``'s discipline, not of its
mechanism. The JAX store serializes traced StableHLO programs; the port
has none to serialize. What a fresh process of the port must otherwise
redo is ``nvcc``: each kernel source (``csrc/<name>.cu``) compiles into a
shared library with a plain C interface, loaded with :mod:`ctypes`
(:mod:`netrep_tpu_torch.ops._build`). This module keeps those libraries
between processes:

- **Key.** A library is named by a digest of its source and the ``nvcc``
  flags (``lib<name>_<digest>.so``). A meta sidecar beside it
  (``lib<name>_<digest>.json``) records the environment it was built in
  (:func:`env_signature`: ``nvcc``'s release, torch's CUDA version, the
  card's compute capability and name). A library whose sidecar names
  another environment, or that has none, is rebuilt from the same source
  in place, with an ``aot_store_miss`` event (``reason="env-mismatch"``)
  and one warning a process. The native tier's host library
  (:mod:`netrep_tpu_torch.native.build`, ``libnetstats_<digest>.so``,
  built by ``g++``) lives here too, keyed by its source, compiler and
  flags; its sidecar records :func:`host_env_signature` (the compiler's
  ``--version`` line, the flags, the ``-march`` level), which needs
  neither ``nvcc`` nor a card.
- **Quarantine.** A library that :class:`ctypes.CDLL` cannot load is
  renamed ``*.bad``, fires the ``aot_refused`` detector, emits
  ``aot_store_miss`` (``reason="corrupt"``) and is rebuilt. A rebuild that
  fails, or a fresh library that does not load, raises: nothing gives way
  to a kernel's plain version.
- **Build lock.** A build holds an exclusive :func:`fcntl.flock` on
  ``lib<name>_<digest>.lock`` and looks again once it has it, so N
  processes booting together on a cold store run ``nvcc`` once per source.
  The lock dies with its process: a killed build leaves no stale lock.
- **Directory and bound.** ``NETREP_AOT_STORE`` names the directory
  (default ``build/netrep_tpu_torch/`` at the root of the checkout);
  ``NETREP_AOT_STORE_MAX_MB`` (default 512) bounds it: after a build, the
  quarantined files go first, then the least recently used libraries of
  other digests (old builds of edited sources), never one this process
  has loaded.
- **Source tag.** Every acquisition of a library by this process is
  logged as ``jit`` (``nvcc`` ran here) or ``aot`` (loaded from the
  store); :func:`run_source` turns the acquisitions since an engine was
  built into the ``source`` of its runs' ``compile_span`` events and the
  ``|src:`` suffix of their perf-ledger fingerprints, with ``memo`` when
  it acquired none (the libraries were loaded before, or its runs launch
  no kernel, as on the CPU).

Not carried over from the JAX store, for want of a meaning here:
``NETREP_AOT_EXPORT`` and ``NETREP_AOT`` (every library is written at its
build and read at its load; there is no jit path to fall back on), the
serialized programs with their abstract-signature and constants keys, the
raw-key bridge, the eager precompile into a persistent compile cache, and
the host-CPU fingerprint of the store's directory (a library depends on
the toolkit and the card, which the sidecar records).
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import logging
import os
import subprocess
import threading
import time
from pathlib import Path

logger = logging.getLogger("netrep_tpu_torch")

#: store directory override
STORE_ENV = "NETREP_AOT_STORE"
#: LRU bound of the store, in MiB (default 512)
MAX_MB_ENV = "NETREP_AOT_STORE_MAX_MB"
#: meta-sidecar format (bump deliberately, with the store tests)
META_FORMAT = 1
#: the default store: ``build/netrep_tpu_torch/`` at the checkout's root
DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / "netrep_tpu_torch"

_WARNED: set[str] = set()
_LOCK = threading.Lock()
_NVCC_RELEASE: dict[str, str] = {}
#: this process's acquisitions, in order: ``(library name, source)``
ACQUIRED: list[tuple[str, str]] = []
#: file names of the libraries this process loaded (kept by :func:`gc`)
_IN_USE: set[str] = set()
#: counters of this process (``stats()``; the warmup report)
COUNTS = {"loads": 0, "builds": 0, "misses": 0, "quarantined": 0,
          "removed": 0}


def store_dir() -> Path:
    """The store's directory: ``$NETREP_AOT_STORE``, else the default."""
    return Path(os.environ.get(STORE_ENV) or DEFAULT_DIR)


def max_bytes() -> int:
    try:
        return int(float(os.environ.get(MAX_MB_ENV, "512")) * 1024 * 1024)
    except ValueError:
        return 512 * 1024 * 1024


def _emit(ev: str, **data) -> None:
    from .telemetry import current

    tel = current()
    if tel is not None:
        tel.emit(ev, **data)


def _warn_once(reason: str, msg: str, *args) -> None:
    """One warning per reason class a process: store hygiene is audible
    once, never a storm."""
    if reason not in _WARNED:
        _WARNED.add(reason)
        logger.warning(msg, *args)


# ---------------------------------------------------------------------------
# environment signature
# ---------------------------------------------------------------------------


def nvcc_release(nvcc: str) -> str:
    """``nvcc --version``'s release line (``"release 12.8, V12.8.93"``),
    read once a process per compiler."""
    out = _NVCC_RELEASE.get(nvcc)
    if out is None:
        proc = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, timeout=60)
        lines = [ln for ln in proc.stdout.splitlines() if "release" in ln]
        out = lines[-1].split(",", 1)[-1].strip() if lines else "unknown"
        _NVCC_RELEASE[nvcc] = out
    return out


def card_signature() -> str:
    """The current card's compute capability and name, or ``none``
    without one."""
    import torch

    if not torch.cuda.is_available():
        return "none"
    dev = torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(dev)
    return f"sm_{major}{minor}:{torch.cuda.get_device_name(dev)}"


def env_signature(nvcc: str) -> str:
    """The environment a library is valid in: ``nvcc``'s release, torch's
    CUDA version, the card's compute capability and name. A library built
    under any other is rebuilt, never loaded."""
    import torch

    return (f"nvcc:{nvcc_release(nvcc)}|torch_cuda:{torch.version.cuda}"
            f"|card:{card_signature()}")


def cxx_release(cxx: str) -> str | None:
    """The first line of ``<cxx> --version`` (``"g++ (Debian 12.2.0-14)
    12.2.0"``), or None when the compiler does not run."""
    try:
        proc = subprocess.run([cxx, "--version"], capture_output=True,
                              text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = proc.stdout.splitlines()
    return lines[0].strip() if lines else ""


def host_env_signature(release: str | None, flags, march: str) -> str:
    """The environment a host library (one built by a C++ compiler, no
    card involved) is valid in: the compiler's ``--version`` line, its
    flags and its ``-march`` level. It needs neither ``nvcc`` nor a card.
    ``release`` None (no compiler) gives the signature's tail alone,
    which :func:`host_entry_ok` matches against any compiler's."""
    tail = f"|flags:{' '.join(flags)}|march:{march or '-'}"
    return tail if release is None else f"cxx:{release}{tail}"


def host_entry_ok(lib: Path, env: str) -> bool:
    """Whether ``lib`` exists with a sidecar of ``env`` — or, for a
    compiler-less ``env`` (only the flags and march tail), of any
    compiler with that tail."""
    if not lib.exists():
        return False
    meta = read_meta(lib) or {}
    got = meta.get("env")
    if meta.get("format") != META_FORMAT or not isinstance(got, str):
        return False
    return got == env or (env.startswith("|") and got.endswith(env))


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------


def meta_path(lib: Path) -> Path:
    return lib.with_suffix(".json")


def read_meta(lib: Path) -> dict | None:
    """The sidecar of ``lib``, or None when it is missing or unreadable."""
    try:
        with open(meta_path(lib), encoding="utf-8") as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    return meta if isinstance(meta, dict) else None


def write_meta(lib: Path, name: str, env: str, seconds: float) -> None:
    meta = {"format": META_FORMAT, "name": name, "env": env,
            "created": time.time(), "build_s": seconds,
            "bytes": lib.stat().st_size}
    tmp = meta_path(lib).with_suffix(f".{os.getpid()}.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_path(lib))


def check_entry(name: str, lib: Path, env: str, quiet: bool = False
                ) -> bool:
    """True when ``lib`` exists and its sidecar names ``env``. A library
    from another environment (or without a sidecar) is a miss: the
    ``aot_store_miss`` event and one warning (unless ``quiet``), then the
    caller rebuilds."""
    if not lib.exists():
        return False
    meta = read_meta(lib)
    if (meta is not None and meta.get("format") == META_FORMAT
            and meta.get("env") == env):
        return True
    if quiet:
        return False
    COUNTS["misses"] += 1
    _emit("aot_store_miss", key=name, reason="env-mismatch",
          lib=lib.name)
    _warn_once("env-mismatch",
               "kernel library %s was built under %r (this process: %r); "
               "it is rebuilt from its source",
               lib.name, (meta or {}).get("env"), env)
    return False


def quarantine(name: str, lib: Path, reason: str) -> None:
    """Rename an unloadable library (and its sidecar) ``*.bad``, fire
    ``aot_refused`` and emit ``aot_store_miss`` (``reason="corrupt"``)."""
    COUNTS["quarantined"] += 1
    COUNTS["misses"] += 1
    for p in (lib, meta_path(lib)):
        with contextlib.suppress(OSError):
            os.replace(p, p.with_name(p.name + ".bad"))
    _warn_once(f"quarantine:{name}",
               "kernel library %s could not be loaded (%s); quarantined "
               "as .bad and rebuilt", lib, reason)
    _emit("aot_store_miss", key=name, reason="corrupt", lib=lib.name)
    from . import detectors

    detectors.fire("aot_refused", reason=reason, path=str(lib))


@contextlib.contextmanager
def build_lock(lib: Path):
    """Exclusive lock on one library's build, across threads and processes
    (each holder opens its own descriptor); released when the holder
    exits, even by a kill."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd = os.open(lib.with_suffix(".lock"), os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def record(name: str, source: str, lib: Path | None = None) -> None:
    """Log one acquisition of library ``name``: ``jit`` or ``aot``; its
    file ``lib`` is then never removed by :func:`gc` in this process."""
    with _LOCK:
        ACQUIRED.append((name, source))
        COUNTS["builds" if source == "jit" else "loads"] += 1
        if lib is not None:
            _IN_USE.add(Path(lib).name)


def mark() -> int:
    """The position in this process's acquisition log (an engine takes one
    when it is built)."""
    return len(ACQUIRED)


def run_source(since: int | None = 0) -> str:
    """``jit`` when ``nvcc`` ran in this process since ``since`` (a
    :func:`mark`), ``aot`` when libraries were loaded from the store and
    none compiled, ``memo`` when nothing was acquired."""
    got = {src for _name, src in ACQUIRED[since or 0:]}
    if "jit" in got:
        return "jit"
    return "aot" if got else "memo"


def touch(lib: Path) -> None:
    """LRU recency for :func:`gc`."""
    with contextlib.suppress(OSError):
        os.utime(lib)


def gc(keep=()) -> int:
    """The size bound: quarantined files go first, then the least recently
    used libraries beyond :func:`max_bytes`, never one in ``keep``.
    Returns the number of files removed."""
    root = store_dir()
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    removed = 0
    for n in names:
        if n.endswith(".bad"):
            with contextlib.suppress(OSError):
                os.unlink(root / n)
                removed += 1
    keep = {Path(k).name for k in keep} | _IN_USE
    libs = []
    total = 0
    for n in names:
        if not n.endswith(".so"):
            continue
        try:
            st = os.stat(root / n)
        except OSError:
            continue
        libs.append((st.st_mtime, st.st_size, n))
        total += st.st_size
    libs.sort()
    limit = max_bytes()
    for _mt, size, n in libs:
        if total <= limit:
            break
        if n in keep:
            continue
        lib = root / n
        for p in (lib, meta_path(lib), lib.with_suffix(".lock")):
            with contextlib.suppress(OSError):
                os.unlink(p)
                removed += 1
        total -= size
    COUNTS["removed"] += removed
    return removed


def stats() -> dict:
    """The store's directory, its libraries and bytes, and this process's
    counters and acquisitions."""
    root = store_dir()
    n = total = 0
    with contextlib.suppress(OSError):
        for name in os.listdir(root):
            if name.endswith(".so"):
                n += 1
                with contextlib.suppress(OSError):
                    total += os.stat(root / name).st_size
    return {"path": str(root), "entries": n, "bytes": total, **COUNTS,
            "acquired": [f"{name}:{src}" for name, src in ACQUIRED]}
