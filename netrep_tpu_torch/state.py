"""The state the port carries across from the JAX package.

NetRep has no weights: what a permutation engine holds is its device
operands — the null's candidate ``pool``, the test correlation, network and
transposed data, each bucket's discovery-side properties, observed index
blocks, capacity and permutation slices — plus the root key of its
permutation stream. :func:`engine_state_from_numpy` builds the port's
engine from those arrays, given as numpy (for instance ``np.asarray`` of a
JAX engine's operands and ``jax.random.key_data`` of its key), so the
port's null can be held against another engine's with the discovery side
identical, free of any drift from recomputing ``eigh``.
"""

from __future__ import annotations

import numpy as np

from .parallel.engine import PermutationEngine
from .random import ThreefryKey
from .utils.config import EngineConfig

#: DiscProps fields, in their order
DISC_FIELDS = ("corr", "sign_corr", "degree", "contrib", "sign_contrib", "mask")


def engine_state_from_numpy(d: dict, config: EngineConfig | None = None,
                            device=None) -> tuple[PermutationEngine,
                                                  ThreefryKey]:
    """Build ``(engine, root_key)`` from numpy state.

    ``d`` holds ``pool`` ``(P,)``, ``test_corr`` and ``test_net`` ``(n,
    n)``, ``test_dataT`` ``(n, s)`` or None, ``n_modules``, ``key_data``
    ``(2,)`` uint32, and ``buckets``: a list of dicts with ``cap``,
    ``module_pos`` ``(K,)``, ``slices`` ``(K, 2)`` (offset, size),
    ``obs_idx`` ``(K, cap)`` and the :data:`DISC_FIELDS` arrays ``(K, cap[,
    cap])``. ``device`` None means ``"cuda"``.
    """
    buckets = [
        {
            "cap": int(b["cap"]),
            "module_pos": np.asarray(b["module_pos"]),
            "slices": np.asarray(b["slices"]).reshape(-1, 2),
            "obs_idx": np.asarray(b["obs_idx"]),
            "disc": tuple(np.asarray(b[f]) for f in DISC_FIELDS),
        }
        for b in d["buckets"]
    ]
    engine = PermutationEngine.from_parts(
        d["test_corr"], d["test_net"], d.get("test_dataT"), d["pool"],
        buckets, int(d["n_modules"]), config or EngineConfig(), device=device,
    )
    return engine, ThreefryKey.from_data(d["key_data"], device=engine.device)
