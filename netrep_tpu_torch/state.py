"""The state the port carries across from the JAX package.

NetRep has no weights: what a permutation engine holds is its device
operands — the null's candidate ``pool``, the test correlation, network and
transposed data, each bucket's discovery-side properties, observed index
blocks, capacity and permutation slices — plus the root key of its
permutation stream. :func:`engine_state_from_numpy` and
:func:`multitest_state_from_numpy` build the port's engines from those
arrays, given as numpy (for instance ``np.asarray`` of a JAX engine's
operands and ``jax.random.key_data`` of its key), so the port's null can be
held against another engine's with the discovery side identical, free of
any drift from recomputing ``eigh``.
"""

from __future__ import annotations

import numpy as np

from .parallel.engine import PermutationEngine
from .parallel.mesh import Mesh
from .parallel.multitest import MultiTestEngine
from .random import ThreefryKey
from .utils.config import EngineConfig

#: DiscProps fields, in their order
DISC_FIELDS = ("corr", "sign_corr", "degree", "contrib", "sign_contrib", "mask")


def _buckets(d: dict) -> list[dict]:
    return [
        {
            "cap": int(b["cap"]),
            "module_pos": np.asarray(b["module_pos"]),
            "slices": np.asarray(b["slices"]).reshape(-1, 2),
            "obs_idx": np.asarray(b["obs_idx"]),
            "disc": tuple(np.asarray(b[f]) for f in DISC_FIELDS),
        }
        for b in d["buckets"]
    ]


def engine_state_from_numpy(d: dict, config: EngineConfig | None = None,
                            device=None, mesh: Mesh | None = None
                            ) -> tuple[PermutationEngine, ThreefryKey]:
    """Build ``(engine, root_key)`` from numpy state.

    ``d`` holds ``pool`` ``(P,)``, ``test_corr`` ``(n, n)``, ``test_net``
    ``(n, n)`` or None (derived-network mode: ``config`` then sets
    ``network_from_correlation``), ``test_dataT`` ``(n, s)`` or None,
    ``n_modules``, ``key_data`` ``(2,)`` uint32, and ``buckets``: a list
    of dicts with ``cap``, ``module_pos`` ``(K,)``, ``slices`` ``(K, 2)``
    (offset, size), ``obs_idx`` ``(K, cap)`` and the :data:`DISC_FIELDS`
    arrays ``(K, cap[, cap])``. ``device`` None means ``"cuda"``. With a
    ``mesh`` the engine is built over it (``config.matrix_sharding`` says
    whether the test matrices are split by rows), so a JAX engine on a mesh
    of the same shape can be held against it.
    """
    engine = PermutationEngine.from_parts(
        d["test_corr"], d.get("test_net"), d.get("test_dataT"), d["pool"],
        _buckets(d), int(d["n_modules"]), config or EngineConfig(),
        device=device, mesh=mesh,
    )
    return engine, ThreefryKey.from_data(d["key_data"], device=engine.device)


def multitest_state_from_numpy(d: dict, config: EngineConfig | None = None,
                               device=None) -> tuple[MultiTestEngine,
                                                     ThreefryKey]:
    """Build ``(multi-test engine, root_key)`` from numpy state: as
    :func:`engine_state_from_numpy` with the test side stacked over T
    cohorts — ``test_corrs`` ``(T, n, n)``, ``test_nets`` ``(T, n, n)`` or
    None, ``test_dataTs`` a list of T ``(n, s_t)`` or None — and the
    discovery ``buckets`` of the base engine."""
    engine = MultiTestEngine.from_parts(
        d["test_corrs"], d.get("test_nets"), d.get("test_dataTs"), d["pool"],
        _buckets(d), int(d["n_modules"]), config or EngineConfig(),
        device=device,
    )
    return engine, ThreefryKey.from_data(d["key_data"], device=engine.device)
