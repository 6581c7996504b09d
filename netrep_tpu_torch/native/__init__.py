"""The native C++ tier — ctypes bindings over the compute core in
``netstats.cpp`` (the reference's ``src/netStats.cpp`` statistic kernels
and ``src/permutations.cpp`` ``PermutationProcedure`` over a thread pool,
SURVEY.md §2.2, BASELINE.json:5).

The port of ``netrep_tpu/native/__init__.py``. The card engine
(:mod:`netrep_tpu_torch.parallel.engine`) is the port's compute path; this
is its host tier: a threaded C++ permutation procedure selected with
``module_preservation(..., backend="native", n_threads=...)``, and an
independent (non-torch) parity oracle. The library is the port's own copy
of the JAX package's source, built into the kernel-library store
(:mod:`netrep_tpu_torch.native.build`); it never loads the JAX package's.

Determinism contract: permutation ``p`` (global index) derives its RNG from
``splitmix64(seed ^ f(p))`` inside the library, so results are invariant to
``n_threads`` and to how the permutation range is chunked across calls —
and equal to the JAX package's native tier, bit for bit.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops import oracle
from ..utils import aot
from ..utils import checkpoint as ckpt
from . import build
from .build import toolchain_available

__all__ = [
    "available",
    "load_library",
    "NativeCore",
    "NativePermutationEngine",
]

_lib = None
_lib_lock = threading.Lock()

_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

#: the checkpoint key data's engine-kind word (``"nativ"``), the JAX
#: package's, so native checkpoints cross packages
KEY_KIND = 0x6E61746976
_MASK64 = 0xFFFFFFFFFFFFFFFF


def available() -> bool:
    """True when the native tier can be used (compiler present or a
    library of this source and flags in the store)."""
    return build.library_path().exists() or toolchain_available()


def _declare(lib) -> None:
    lib.nr_abi_version.restype = ctypes.c_int
    lib.nr_abi_version.argtypes = []
    lib.nr_observed.restype = None
    lib.nr_observed.argtypes = [
        _F64, _F64, ctypes.c_void_p,            # tcorr, tnet, tdata(|0)
        ctypes.c_int, ctypes.c_int,             # n, s
        _I32, _I32, ctypes.c_int,               # idx_cat, sizes, n_mod
        _F64, _F64, ctypes.c_void_p,            # disc corr/deg/contrib(|0)
        _F64,                                   # out
    ]
    lib.nr_null.restype = ctypes.c_longlong
    lib.nr_null.argtypes = [
        _F64, _F64, ctypes.c_void_p,            # tcorr, tnet, tdata(|0)
        ctypes.c_int, ctypes.c_int,             # n, s
        _I32, ctypes.c_int,                     # pool, pool_size
        _I32, ctypes.c_int,                     # sizes, n_mod
        _F64, _F64, ctypes.c_void_p,            # disc corr/deg/contrib(|0)
        ctypes.c_longlong, ctypes.c_longlong,   # n_perm, perm_offset
        ctypes.c_ulonglong, ctypes.c_int,       # seed, n_threads
        _F64,                                   # nulls out
        ctypes.c_void_p,                        # progress (long long*)|0
        ctypes.c_void_p,                        # cancel (int*)|0
    ]
    lib.nr_props.restype = None
    lib.nr_props.argtypes = [
        _F64, _F64, ctypes.c_void_p,            # corr, net, data(|0)
        ctypes.c_int, ctypes.c_int,             # n, s
        _I32, ctypes.c_int,                     # idx, m
        _F64, _F64, _F64,                       # degree, contrib, profile
        ctypes.POINTER(ctypes.c_double),        # coherence
        ctypes.POINTER(ctypes.c_double),        # avg_weight
    ]


def load_library():
    """Build (if needed) and load the shared library; idempotent. A
    library the loader refuses is quarantined and rebuilt once; a rebuilt
    one it refuses raises."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        for attempt in (0, 1):
            path, source = build.ensure_built()
            try:
                lib = ctypes.CDLL(str(path))
                break
            except OSError as e:
                if attempt or source == "jit":
                    raise RuntimeError(
                        f"native library {path} does not load: {e}") from e
                aot.quarantine(build.NAME, path, f"{type(e).__name__}: {e}")
        _declare(lib)
        if lib.nr_abi_version() != 1:
            raise RuntimeError("native library ABI mismatch; delete "
                               f"{path} and rebuild")
        aot.touch(path)
        aot.record(build.NAME, source, path)
        _lib = lib
        return _lib


def _c(a: np.ndarray, dtype) -> np.ndarray:
    """Adopt ``a`` for the C ABI. Zero-copy when already C-contiguous with
    the right dtype (``ascontiguousarray`` returns the SAME object then) —
    the native analogue of the reference's no-copy Armadillo adoption of R
    matrices (SURVEY.md §2.2 "Zero-copy matrix adoption"); genome-scale
    float64 matrices are never duplicated. Other dtypes/layouts pay one
    conversion copy, which the C kernels require. Pinned by
    tests/test_torch_native.py::test_zero_copy_adoption."""
    return np.ascontiguousarray(a, dtype=dtype)


def _opt_ptr(a: np.ndarray | None):
    """void* for an optional float64 array (NULL when absent)."""
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeCore:
    """Thin stateful wrapper holding one (discovery, test) problem in native
    layout: discovery per-module properties are precomputed once (the fixed
    side of every statistic, SURVEY.md §3.1) by the float64 oracle, in the
    JAX package's operation order, and concatenated for the C ABI."""

    def __init__(
        self,
        disc_corr: np.ndarray,
        disc_net: np.ndarray,
        disc_data: np.ndarray | None,
        test_corr: np.ndarray,
        test_net: np.ndarray,
        test_data: np.ndarray | None,
        modules: Sequence,          # ModuleSpec-likes: .disc_idx/.test_idx
        pool: np.ndarray,
    ):
        self.lib = load_library()
        self.test_corr = _c(test_corr, np.float64)
        self.test_net = _c(test_net, np.float64)
        self.with_data = disc_data is not None and test_data is not None
        self.test_data = (
            _c(test_data, np.float64) if self.with_data else None
        )
        self.n = self.test_corr.shape[0]
        self.s = self.test_data.shape[0] if self.with_data else 0
        self.pool = _c(pool, np.int32)
        self.sizes = np.asarray([len(m.test_idx) for m in modules], np.int32)
        self.n_mod = len(modules)
        self.obs_idx = _c(
            np.concatenate([np.asarray(m.test_idx) for m in modules]),
            np.int32,
        )

        corr_cat, deg_cat, contrib_cat = [], [], []
        for m in modules:
            di = np.asarray(m.disc_idx)
            sub_corr = disc_corr[np.ix_(di, di)]
            sub_net = disc_net[np.ix_(di, di)]
            corr_cat.append(np.asarray(sub_corr, np.float64).ravel())
            deg_cat.append(oracle.weighted_degree(sub_net))
            if self.with_data:
                contrib_cat.append(
                    oracle.node_contribution(disc_data[:, di])
                )
        self.disc_corr_cat = _c(np.concatenate(corr_cat), np.float64)
        self.disc_deg_cat = _c(np.concatenate(deg_cat), np.float64)
        self.disc_contrib_cat = (
            _c(np.concatenate(contrib_cat), np.float64)
            if self.with_data else None
        )

    def observed(self) -> np.ndarray:
        out = np.empty((self.n_mod, oracle.N_STATS), np.float64)
        self.lib.nr_observed(
            self.test_corr, self.test_net, _opt_ptr(self.test_data),
            self.n, self.s, self.obs_idx, self.sizes, self.n_mod,
            self.disc_corr_cat, self.disc_deg_cat,
            _opt_ptr(self.disc_contrib_cat), out,
        )
        return out

    def null(
        self,
        n_perm: int,
        seed: int = 0,
        perm_offset: int = 0,
        n_threads: int = 0,
        out: np.ndarray | None = None,
        progress_buf: np.ndarray | None = None,
        cancel_buf: np.ndarray | None = None,
    ) -> tuple[np.ndarray, int]:
        """Run permutations [perm_offset, perm_offset + n_perm) of stream
        ``seed``. Returns ``(nulls, completed)``."""
        if out is None:
            out = np.empty((n_perm, self.n_mod, oracle.N_STATS), np.float64)
        done = self.lib.nr_null(
            self.test_corr, self.test_net, _opt_ptr(self.test_data),
            self.n, self.s, self.pool, self.pool.size,
            self.sizes, self.n_mod,
            self.disc_corr_cat, self.disc_deg_cat,
            _opt_ptr(self.disc_contrib_cat),
            n_perm, perm_offset,
            np.uint64(int(seed) & _MASK64), n_threads, out,
            _opt_ptr(progress_buf), _opt_ptr(cancel_buf),
        )
        if done < 0:
            raise ValueError("module sizes exceed the candidate pool")
        return out, int(done)


class NativePermutationEngine:
    """Interface-compatible counterpart of
    :class:`netrep_tpu_torch.parallel.engine.PermutationEngine` backed by
    the C++ core, so ``module_preservation(backend='native')`` can swap it
    in. It runs on the host: ``device`` is the CPU.

    The permutation range is dispatched to the library in chunks of the
    port's one materialized loop
    (:func:`~netrep_tpu_torch.parallel.engine.run_checkpointed_chunks`, with
    this engine's ``perm_keys``), so Python regains control between calls:
    a ``KeyboardInterrupt`` lands between chunks (the reference's
    cooperative Ctrl-C path, SURVEY.md §5) and partial nulls are kept and
    checkpointed exactly like the card engine's. The last chunk is clamped
    to the exact remainder.
    """

    device = torch.device("cpu")

    def __init__(
        self,
        disc_corr, disc_net, disc_data,
        test_corr, test_net, test_data,
        modules, pool,
        config=None,
        mesh=None,  # accepted for signature parity; meaningless on CPU
        n_threads: int = 0,
    ):
        del mesh
        # The bf16 screened fast-pass is a card-engine feature; this tier
        # is exact f64 throughout. 'auto' means f32 here, an explicit ask
        # refuses.
        if getattr(config, "null_precision", "auto") == "bf16_rescue":
            raise ValueError(
                "null_precision='bf16_rescue' is not supported on "
                "backend='native'; use 'auto' or 'f32'"
            )
        self._lib_mark = aot.mark()
        self.core = NativeCore(
            np.asarray(disc_corr), np.asarray(disc_net),
            None if disc_data is None else np.asarray(disc_data),
            np.asarray(test_corr), np.asarray(test_net),
            None if test_data is None else np.asarray(test_data),
            modules, np.asarray(pool),
        )
        self.modules = list(modules)
        self.pool = self.core.pool          # checkpoint fingerprint fields
        self.has_data = self.core.with_data
        self.chunk = max(
            64, int(getattr(config, "chunk_size", 1024) or 1024)
        )
        self.n_threads = n_threads

    def observed(self) -> np.ndarray:
        return self.core.observed()

    def release(self) -> None:
        """Nothing to give back: the engine holds no device memory (the
        fault ladder calls it before a rebuild)."""

    # -- hooks of the chunk loop and the checkpoint identity ---------------

    def prepare_key(self, key) -> int:
        if not isinstance(key, (int, np.integer)):
            raise TypeError(
                "backend='native' takes an integer seed, got "
                f"{type(key).__name__}; jax PRNG keys only apply to the "
                "default backend='jax'"
            )
        # mask to the counter-based generator's 64-bit seed space (matches
        # core.null) so negative seeds round-trip through checkpoints
        return int(key) & _MASK64

    def key_data(self, key) -> np.ndarray:
        """RNG-stream identity stored in checkpoints: (engine kind, seed) —
        the JAX package's, so a native checkpoint resumes in either
        package. Distinct from the card engine's Threefry key data, so
        resuming a card checkpoint on the native tier (different null
        samples) is refused rather than spliced."""
        return np.asarray([KEY_KIND, int(key) & _MASK64], dtype=np.uint64)

    def effective_chunk(self) -> int:
        return self.chunk

    @staticmethod
    def perm_keys(key: int, start: int, count: int):
        # the native RNG is counter-based on the global permutation index;
        # the "keys" for a chunk are just its (seed, offset, count) triple
        return (int(key), int(start), int(count))

    def fingerprint_arrays(self):
        c = self.core
        return [c.test_corr, c.test_net, c.test_data,
                c.disc_corr_cat, c.disc_deg_cat, c.disc_contrib_cat]

    def fingerprint_digest(self) -> str:
        """The JAX package's digest of :meth:`fingerprint_arrays`."""
        return ckpt.content_digest(self.fingerprint_arrays())

    def run_null(
        self,
        n_perm: int,
        key: int = 0,
        progress: Callable[[int, int], None] | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 8192,
        fault_policy=None,
        observed=None,  # signature parity with the card engine; exact
        telemetry=None,
        profile=None,
    ) -> tuple[np.ndarray, int]:
        del observed
        from ..parallel.engine import Checkpointer, run_checkpointed_chunks

        seed = self.prepare_key(key)
        ck = None
        if checkpoint_path is not None:
            ck = Checkpointer(str(checkpoint_path), int(checkpoint_every),
                              self.key_data(seed),
                              ckpt.engine_fingerprint(self))

        def fn(spec):
            seed_, start, count = spec
            out, completed = self.core.null(
                count, seed=seed_, perm_offset=start,
                n_threads=self.n_threads)
            if completed < count:  # cancelled mid-chunk (cooperative flag)
                out[completed:] = np.nan
            return out

        def write(nulls, out, done, take):
            nulls[done:done + take] = out[:take]

        return run_checkpointed_chunks(
            seed, n_perm, self.effective_chunk(), fn, write,
            (n_perm, self.core.n_mod, oracle.N_STATS), progress, ck,
            fault_policy=fault_policy, telemetry=telemetry, profile=profile,
            device=self.device, engine=self, perm_keys=self.perm_keys,
        )
