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

Checkpoints carry the T axis (``perm_axis=1``) and the test side's
digest and cohort count (:meth:`MultiTestEngine._fingerprint_extra`), as
the JAX package's do. The adaptive loops fold the T cohorts into the stop
monitor's cell axis, ``(n_modules, T*7)``: a module retires only when it
is decided in every cohort. The mesh and row-sharded compositions and the
bf16 screen are later slices (ROADMAP.md, Queue 1 items 14 and 13).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .. import random as trandom
from ..ops.oracle import N_STATS
from ..ops.sequential import StopMonitor, StopRule
from ..utils import checkpoint as ckpt
from ..utils.config import EngineConfig, resolve_device
from .engine import (
    _STREAM_FP, ModuleSpec, PermutationEngine, StreamCounts, _as_f32,
    build_discovery, check_derived_network, checkpointer, chunk_counts,
    pull_tallies,
    root_key, run_adaptive_chunks, run_adaptive_stream_chunks,
    run_checkpointed_chunks, run_stream_superchunks,
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
        # the checkpoint identity digests the inputs as given, as the JAX
        # package's engine does (its discovery-only base engine, and the
        # test side stacked)
        self._digest = ckpt.content_digest(
            [disc_corr, disc_net,
             disc_data if test_datas is not None else None, None, None,
             None])
        self._test_digest = ckpt.content_digest(
            [_stacked(test_corrs), _stacked(test_nets)]
            + ([] if test_datas is None else list(test_datas)))

    @classmethod
    def from_parts(cls, test_corrs, test_nets, test_dataTs, pool, buckets,
                   n_modules: int, config: EngineConfig = EngineConfig(),
                   device=None, modules: Sequence[ModuleSpec] | None = None,
                   digest: str | None = None,
                   test_digest: str | None = None) -> "MultiTestEngine":
        """An engine from its device operands directly (see
        :func:`netrep_tpu_torch.state.multitest_state_from_numpy`): T test
        correlations, networks (or None) and transposed data ``(n,
        samples_t)`` (or None), with the discovery buckets of
        :meth:`PermutationEngine.from_parts`. ``modules``, ``digest`` (of
        the discovery inputs) and ``test_digest`` (of the stacked test
        inputs) make the checkpoint identity; without them the engine
        takes no checkpoint."""
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
        self.modules = None if modules is None else list(modules)
        self._digest, self._test_digest = digest, test_digest
        return self

    def _setup(self, cohorts: list[PermutationEngine]) -> None:
        #: one single-test engine per cohort; they share the discovery
        #: buckets' tensors and the pool
        self.cohorts = cohorts
        c0 = cohorts[0]
        self.config, self.device = c0.config, c0.device
        self.n_modules, self.has_data = c0.n_modules, c0.has_data
        self.stat_mode = c0.stat_mode
        self.net_beta = c0.net_beta
        self.pool, self._pool_dev = c0.pool, c0._pool_dev

    @property
    def buckets(self):
        """The active buckets (every cohort's are the same modules)."""
        return self.cohorts[0].buckets

    def observed(self) -> np.ndarray:
        """(T, n_modules, 7) observed statistics, exact ``eigh``."""
        return np.stack([c.observed() for c in self.cohorts])

    def _chunk(self, keys: trandom.ThreefryKey) -> list[torch.Tensor]:
        """Per-bucket ``(T, C, K, 7)`` null statistics: one permutation
        draw, every cohort's null body over the shared index blocks."""
        perm = trandom.permutation(keys, self._pool_dev)
        per_t = [c._values(perm) for c in self.cohorts]
        return [torch.stack(outs) for outs in zip(*per_t)]

    # ------------------------------------------------------------------
    # Checkpoint identity and retirement
    # ------------------------------------------------------------------

    def fingerprint_digest(self) -> str:
        """Digest of the discovery inputs (the JAX package's
        discovery-only base engine's)."""
        if self._digest is None or self.modules is None:
            raise ValueError(
                "this engine was built from parts without modules=, "
                "digest= and test_digest=, so it has no checkpoint "
                "identity; pass them to from_parts or build it from the "
                "inputs"
            )
        return self._digest

    def _fingerprint_extra(self) -> bytes:
        """The test side's part of the checkpoint identity: the cohort
        count and the digest of the stacked test inputs."""
        return f"|T:{self.T}|td:{self._test_digest}".encode()

    def rebucket(self, active) -> None:
        """Restrict every cohort to the modules at ``active``
        (:meth:`PermutationEngine.rebucket`)."""
        for c in self.cohorts:
            c.rebucket(active)

    def _null_write(self) -> Callable:
        def write(nulls, outs, done, take):
            for b, o in zip(self.buckets, outs):
                nulls[:, done: done + take, b.module_pos] = (
                    o[:, :take].cpu().numpy().astype(np.float64)
                )

        return write

    # ------------------------------------------------------------------
    # Null runs
    # ------------------------------------------------------------------

    def run_null(self, n_perm: int, key=0,
                 progress: Callable[[int, int], None] | None = None,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 8192,
                 ) -> tuple[np.ndarray, int]:
        """``(nulls, completed)`` with ``nulls`` ``(T, n_perm, n_modules,
        7)`` float64; same key ⇒ cohort t's null equals the single-test
        engine's on cohort t. Checkpoints as
        :meth:`PermutationEngine.run_null`, the permutation axis second."""
        key = root_key(key, self.device)
        return run_checkpointed_chunks(
            key, n_perm, self.config.chunk_size, self._chunk,
            self._null_write(), (self.T, n_perm, self.n_modules, N_STATS),
            progress,
            checkpointer(self, key, checkpoint_path, checkpoint_every,
                         self._fingerprint_extra()),
            perm_axis=1,
        )

    def _stream_parts(self, observed):
        """``(count(keys, valid), pull())`` over the shared draw: each
        cohort's tallies on the device, all of them read in one copy."""
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
            per_t = pull_tallies(
                [(c.buckets, acc) for c, acc in zip(self.cohorts, tallies)],
                self.n_modules)
            return tuple(np.stack(per_t, axis=1))

        return count, pull

    def run_null_streaming(self, n_perm: int, observed, key=0,
                           progress: Callable[[int, int], None] | None = None,
                           checkpoint_path: str | None = None,
                           checkpoint_every: int = 8192,
                           ) -> StreamCounts:
        """Exceedance tallies against ``observed`` ``(T, n_modules, 7)``
        over the shared permutation draw: a
        :class:`~netrep_tpu_torch.parallel.engine.StreamCounts` with ``(T,
        n_modules, 7)`` tallies, equal to ``tail_counts`` of
        :meth:`run_null`'s null per cohort."""
        key = root_key(key, self.device)
        count, pull = self._stream_parts(observed)
        (hi, lo, eff), completed = run_stream_superchunks(
            key, n_perm, self.config.chunk_size,
            self.config.resolved_superchunk, count, pull, progress,
            checkpointer(self, key, checkpoint_path, checkpoint_every,
                         _STREAM_FP + self._fingerprint_extra()),
        )
        return StreamCounts(hi=hi, lo=lo, eff=eff, completed=completed)

    def _monitor(self, observed, alternative, rule) -> StopMonitor:
        obs = np.asarray(observed, dtype=np.float64)
        return StopMonitor(np.moveaxis(obs, 0, 1).reshape(self.n_modules, -1),
                           alternative, rule or StopRule())

    def run_null_adaptive(self, n_perm: int, observed, key=0,
                          alternative: str = "greater", rule=None,
                          progress: Callable[[int, int], None] | None = None,
                          checkpoint_path: str | None = None,
                          checkpoint_every: int = 8192,
                          ) -> tuple[np.ndarray, int, bool]:
        """Sequential early-stopping variant of :meth:`run_null`
        (:meth:`PermutationEngine.run_null_adaptive`): the ``(T,
        n_modules, 7)`` observed statistics fold into the monitor's cells
        as ``(n_modules, T*7)``, so a module retires only when it is
        decided in every cohort."""
        return self.run_null_monitored(
            n_perm, key, self._monitor(observed, alternative, rule),
            progress=progress, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every)

    def run_null_monitored(self, n_perm: int, key, monitor,
                           progress: Callable[[int, int], None] | None = None,
                           checkpoint_path: str | None = None,
                           checkpoint_every: int = 8192,
                           ) -> tuple[np.ndarray, int, bool]:
        """The T-cohort null under a caller's retirement monitor whose cell
        axis is ``(n_modules, T*7)``; the engine is left at full strength
        on exit."""
        key = root_key(key, self.device)

        def slice_vals(nulls, done, take, pos):
            block = nulls[:, done: done + take][:, :, pos, :]
            return np.moveaxis(block, 0, 2).reshape(take, pos.size, -1)

        try:
            return run_adaptive_chunks(
                key, n_perm, self.config.chunk_size, self._chunk,
                self._null_write(),
                (self.T, n_perm, self.n_modules, N_STATS), slice_vals,
                monitor, self.rebucket, progress,
                checkpointer(self, key, checkpoint_path, checkpoint_every,
                             self._fingerprint_extra()),
                perm_axis=1,
            )
        finally:
            self.rebucket(range(self.n_modules))

    def run_null_adaptive_streaming(
            self, n_perm: int, observed, key=0, alternative: str = "greater",
            rule=None, progress: Callable[[int, int], None] | None = None,
            checkpoint_path: str | None = None, checkpoint_every: int = 8192,
    ) -> StreamCounts:
        """Streaming variant of :meth:`run_null_adaptive`: the monitor
        folds each chunk's (cohort × statistic) tallies; a
        :class:`~netrep_tpu_torch.parallel.engine.StreamCounts` with
        ``(T, n_modules, 7)`` tallies and per-module ``n_perm_used``."""
        monitor = self._monitor(observed, alternative, rule)
        key = root_key(key, self.device)

        def to_cells(a, pos):
            # (T, n_modules, 7) -> the monitor's (n_active, T*7) cells
            return np.moveaxis(a[:, pos], 0, 1).reshape(pos.size, -1)

        try:
            completed, finished = run_adaptive_stream_chunks(
                key, n_perm, self.config.chunk_size,
                chunk_counts(lambda: self._stream_parts(observed), monitor,
                             to_cells), monitor,
                self.rebucket, progress,
                checkpointer(self, key, checkpoint_path, checkpoint_every,
                             _STREAM_FP + self._fingerprint_extra()),
            )
        finally:
            self.rebucket(range(self.n_modules))

        def to_result(a):
            # (n_modules, T*7) monitor cells -> (T, n_modules, 7)
            return np.moveaxis(
                np.asarray(a).reshape(self.n_modules, self.T, N_STATS), 0, 1
            ).copy()

        eff = monitor.eff if monitor.eff is not None else np.zeros_like(
            monitor.hi)
        return StreamCounts(
            hi=to_result(monitor.hi), lo=to_result(monitor.lo),
            eff=to_result(eff), completed=completed,
            n_perm_used=monitor.n_used.copy(), finished=finished,
        )


def _stacked(mats):
    """What the JAX package digests for T matrices: their stack (a
    stacked array as it is)."""
    if mats is None:
        return None
    if isinstance(mats, (list, tuple)):
        return ckpt.Stack(mats)
    return mats
