"""Permutation engine for one discovery dataset against T test cohorts that
share a node universe (the JAX package's ``vmap_tests=True``, Config C).

The port of the fixed-n, replicated path of
``netrep_tpu/parallel/multitest.py``'s ``MultiTestEngine``: the discovery
side is bucketed once, each cohort keeps its own test operands, and every
chunk draws ONE permutation batch that all T cohorts share. Per bucket the
shared index blocks go through each cohort's null body in turn — one
fused-statistics launch per cohort (``stat_mode='fused'``) or the composed
statistics with one gather launch per cohort and stored matrix
(``'xla'``) — so cohort t's null equals the single-test engine's on cohort
t for the same key. Sample counts may differ between cohorts.

Each (discovery, cohort) null stays valid on its own: the cohorts' matrices
are independent of the shared index draw; only the joint distribution
across cohorts is coupled, which per-pair p-values do not read.

The mesh and row-sharded compositions, checkpoints, the bf16 screen and the
adaptive and monitored loops (``rebucket``) are later slices (ROADMAP.md,
Queue 1).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .. import random as trandom
from ..ops.oracle import N_STATS
from ..utils.config import EngineConfig, resolve_device
from .engine import (
    ModuleSpec, PermutationEngine, StreamCounts, _as_f32, _run_chunks,
    _run_stream, build_discovery, check_derived_network, root_key,
)


class MultiTestEngine:
    """Permutation engine for one discovery dataset against T test datasets
    with identical node universes.

    Parameters
    ----------
    disc_corr, disc_net, disc_data : the discovery dataset (as
        :class:`~netrep_tpu_torch.parallel.engine.PermutationEngine`).
    test_corrs, test_nets : T ``(n, n)`` matrices each (a sequence or a
        stacked ``(T, n, n)`` array).
    test_datas : T ``(samples_t, n)`` data matrices (ragged sample counts
        allowed), or None (data-less).
    modules, pool, config, device : as for ``PermutationEngine``.
    """

    def __init__(self, disc_corr, disc_net, disc_data, test_corrs, test_nets,
                 test_datas, modules: Sequence[ModuleSpec], pool,
                 config: EngineConfig = EngineConfig(), device=None):
        dev = resolve_device(device)
        modules = list(modules)
        self.T = len(test_corrs)
        net_beta = config.network_from_correlation
        pool = np.asarray(pool, dtype=np.int32)
        buckets = build_discovery(
            disc_corr, disc_net, disc_data if test_datas is not None else None,
            modules, pool, config, dev,
        )
        if net_beta is not None:
            for t in range(self.T):
                check_derived_network(test_corrs[t], test_nets[t], net_beta,
                                      f"test[{t}]")
        self._setup([
            PermutationEngine.from_parts(
                _as_f32(test_corrs[t], dev),
                None if net_beta is not None else _as_f32(test_nets[t], dev),
                None if test_datas is None
                else _as_f32(test_datas[t], dev).T,
                pool, buckets, len(modules), config, dev,
            )
            for t in range(self.T)
        ])
        self.modules = modules

    @classmethod
    def from_parts(cls, test_corrs, test_nets, test_dataTs, pool, buckets,
                   n_modules: int, config: EngineConfig = EngineConfig(),
                   device=None) -> "MultiTestEngine":
        """An engine from its device operands directly (see
        :func:`netrep_tpu_torch.state.multitest_state_from_numpy`): T test
        correlations, networks (or None) and transposed data ``(n,
        samples_t)`` (or None), with the discovery buckets of
        :meth:`PermutationEngine.from_parts`."""
        self = cls.__new__(cls)
        T = len(test_corrs)
        self.T = T
        self._setup([
            PermutationEngine.from_parts(
                test_corrs[t], None if test_nets is None else test_nets[t],
                None if test_dataTs is None else test_dataTs[t],
                pool, buckets, n_modules, config, device,
            )
            for t in range(T)
        ])
        self.modules = None
        return self

    def _setup(self, cohorts: list[PermutationEngine]) -> None:
        #: one single-test engine per cohort; they share the discovery
        #: buckets' tensors and the pool
        self.cohorts = cohorts
        c0 = cohorts[0]
        self.config, self.device = c0.config, c0.device
        self.n_modules, self.buckets = c0.n_modules, c0.buckets
        self.stat_mode = c0.stat_mode
        self.net_beta = c0.net_beta
        self.pool, self._pool_dev = c0.pool, c0._pool_dev

    def observed(self) -> np.ndarray:
        """(T, n_modules, 7) observed statistics, exact ``eigh``."""
        return np.stack([c.observed() for c in self.cohorts])

    def _chunk(self, keys: trandom.ThreefryKey) -> list[torch.Tensor]:
        """Per-bucket ``(T, C, K, 7)`` null statistics: one permutation
        draw, every cohort's null body over the shared index blocks."""
        perm = trandom.permutation(keys, self._pool_dev)
        per_t = [c._values(perm) for c in self.cohorts]
        return [torch.stack(outs) for outs in zip(*per_t)]

    def run_null(self, n_perm: int, key=0,
                 progress: Callable[[int, int], None] | None = None,
                 ) -> tuple[np.ndarray, int]:
        """``(nulls, completed)`` with ``nulls`` ``(T, n_perm, n_modules,
        7)`` float64; same key ⇒ cohort t's null equals the single-test
        engine's on cohort t."""
        nulls = np.full((self.T, n_perm, self.n_modules, N_STATS), np.nan)

        def write(outs, at, take):
            for b, o in zip(self.buckets, outs):
                nulls[:, at: at + take, b.module_pos] = (
                    o.cpu().numpy().astype(np.float64)
                )

        completed = _run_chunks(root_key(key, self.device), n_perm,
                                self.config.chunk_size, self._chunk, write,
                                progress)
        return nulls, completed

    def run_null_streaming(self, n_perm: int, observed, key=0,
                           progress: Callable[[int, int], None] | None = None,
                           ) -> StreamCounts:
        """Exceedance tallies against ``observed`` ``(T, n_modules, 7)``
        over the shared permutation draw: a
        :class:`~netrep_tpu_torch.parallel.engine.StreamCounts` with ``(T,
        n_modules, 7)`` tallies, equal to ``tail_counts`` of
        :meth:`run_null`'s null per cohort."""
        observed = np.asarray(observed, dtype=np.float64).reshape(
            self.T, self.n_modules, N_STATS
        )
        obs = [c._obs_buckets(observed[t]) for t, c in
               enumerate(self.cohorts)]
        tallies = [c._zero_tallies() for c in self.cohorts]

        def count(keys, valid):
            perm = trandom.permutation(keys, self._pool_dev)
            for c, ob, acc in zip(self.cohorts, obs, tallies):
                c._count(perm, valid, ob, acc)

        def pull():
            per_t = [c._pull(acc) for c, acc in zip(self.cohorts, tallies)]
            return tuple(np.stack(x) for x in zip(*per_t))

        (hi, lo, eff), completed = _run_stream(
            root_key(key, self.device), n_perm, self.config.chunk_size,
            self.config.resolved_superchunk, count, pull, progress,
        )
        return StreamCounts(hi=hi, lo=lo, eff=eff, completed=completed)
