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
is decided in every cohort. Each cohort stores its test side in
``config.dtype`` (float32 or bfloat16), as the single-test engine does.
The screened null runs on the single-test engine only: an explicit
``null_precision='bf16_rescue'`` raises the JAX package's error, and
``'auto'`` resolves to ``'f32'``.

On a mesh (``mesh=``) each cohort's engine is built over it and the
engine composes their shard plans: each perm shard draws its slice of the
chunk's keys once and hands that draw to every cohort's view on the same
device (the JAX package's T axis inside one ``shard_map``). Replicated
matrices run each cohort's fused or composed body per shard; row-sharded
matrices (``matrix_sharding='row'``) hold each cohort's row blocks on
their own and assemble each cohort's submatrices by the psum gather, one
launch per row block, matrix and cohort. The row-sharded composition never
takes the single-test ring: ``stat_mode='auto'`` resolves to ``'xla'``
there and an explicit ``'fused'`` raises the JAX package's error. A mesh
whose perm axis spans processes runs each process's shards only, as the
single-test engine does (:mod:`netrep_tpu_torch.parallel.distributed`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from .. import random as trandom
from ..ops.oracle import N_STATS
from ..ops.sequential import StopMonitor, StopRule
from ..utils import aot
from ..utils import checkpoint as ckpt
from ..utils.config import EngineConfig
from . import distributed
from . import mesh as tmesh
from .engine import (
    _STREAM_FP, ModuleSpec, PermutationEngine, StreamCounts, _as_stored,
    _check_sharding, build_discovery, check_derived_network, checkpointer,
    chunk_counts, pull_tallies, resolve_stream_superchunk, root_key,
    run_adaptive_chunks, run_adaptive_stream_chunks,
    run_checkpointed_chunks, run_stream_superchunks, Tallies,
)
from .mesh import Mesh


def _mesh_config(config: EngineConfig, mesh: Mesh | None) -> EngineConfig:
    """``config`` for the cohorts' engines: on row-sharded matrices the
    fused statistics (whose row-sharded form is the single-test ring)
    become the composed ones, and an explicit ``stat_mode='fused'``
    raises the JAX package's error."""
    if (_check_sharding(config, mesh)
            and config.resolved_stat_mode() == "fused"):
        if config.stat_mode == "fused":
            raise ValueError(
                "stat_mode='fused' with matrix_sharding='row' is not "
                "supported on the multi-test engine; use the single-"
                "test engine's ring path or stat_mode='xla'"
            )
        return dataclasses.replace(config, stat_mode="xla")
    return config


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
    modules, pool, config, device, mesh : as for ``PermutationEngine``
        (on row-sharded matrices ``stat_mode='auto'`` is ``'xla'``).
    """

    def __init__(self, disc_corr, disc_net, disc_data, test_corrs, test_nets,
                 test_datas, modules: Sequence[ModuleSpec], pool,
                 config: EngineConfig = EngineConfig(), device=None,
                 mesh: Mesh | None = None):
        dev = tmesh.resolve_device(mesh, device)
        config = _mesh_config(config, mesh)
        self._lib_mark = aot.mark()
        modules = list(modules)
        self.T = len(test_corrs)
        net_beta = config.network_from_correlation
        pool = np.asarray(pool, dtype=np.int32)
        buckets = build_discovery(
            disc_corr, disc_net, disc_data if test_datas is not None else None,
            modules, pool, config, dev, mesh,
        )
        if net_beta is not None:
            for t in range(self.T):
                check_derived_network(test_corrs[t], test_nets[t], net_beta,
                                      f"test[{t}]")
        st = config.torch_dtype
        self._setup([
            PermutationEngine.from_parts(
                _as_stored(test_corrs[t], dev, st),
                None if net_beta is not None
                else _as_stored(test_nets[t], dev, st),
                None if test_datas is None
                else _as_stored(test_datas[t], dev, st).T,
                pool, buckets, len(modules), config, dev, mesh,
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
                   test_digest: str | None = None,
                   mesh: Mesh | None = None) -> "MultiTestEngine":
        """An engine from its device operands directly (see
        :func:`netrep_tpu_torch.state.multitest_state_from_numpy`): T test
        correlations, networks (or None) and transposed data ``(n,
        samples_t)`` (or None), with the discovery buckets of
        :meth:`PermutationEngine.from_parts` (on a row-sharded ``mesh``,
        built through its perm row 0). ``modules``, ``digest`` (of the
        discovery inputs) and ``test_digest`` (of the stacked test inputs)
        make the checkpoint identity; without them the engine takes no
        checkpoint."""
        config = _mesh_config(config, mesh)
        self = cls.__new__(cls)
        self._lib_mark = aot.mark()
        T = len(test_corrs)
        self.T = T
        self._setup([
            PermutationEngine.from_parts(
                test_corrs[t], None if test_nets is None else test_nets[t],
                None if test_dataTs is None else test_dataTs[t],
                pool, buckets, n_modules, config, device, mesh,
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
        if c0.config.null_precision == "bf16_rescue":
            raise ValueError(
                "null_precision='bf16_rescue' is not supported on the "
                "multi-test engine (vmap_tests=True); use 'auto' or 'f32', "
                "or run tests sequentially"
            )
        self.config, self.device, self.mesh = c0.config, c0.device, c0.mesh
        self.n_modules, self.has_data = c0.n_modules, c0.has_data
        self.stat_mode = c0.stat_mode
        self.net_beta = c0.net_beta
        self.pool = c0.pool

    @property
    def buckets(self):
        """The active buckets (every cohort's are the same modules)."""
        return self.cohorts[0].buckets

    def observed(self) -> np.ndarray:
        """(T, n_modules, 7) observed statistics, exact ``eigh``."""
        return np.stack([c.observed() for c in self.cohorts])

    def effective_chunk(self) -> int:
        """Chunk size, rounded to a multiple of the mesh's perm axis
        (:meth:`PermutationEngine.effective_chunk`; never over the row axis:
        no cohort takes the ring)."""
        return self.cohorts[0].effective_chunk()

    def _plans(self) -> list:
        """``(slice of the chunk, [view of each cohort])`` per shard this
        process drives, in chunk order: on a mesh the cohorts' shard plans
        side by side (the same positions and devices, each cohort's own
        operands), else the whole chunk on the cohorts themselves."""
        if self.mesh is None:
            return [(slice(None), self.cohorts)]
        plans = [c._shard_plan() for c in self.cohorts]
        return [(shards[0][2], [s[3] for s in shards])
                for shards in zip(*plans)]

    def _spans_processes(self) -> bool:
        return self.mesh is not None and self.mesh.spans_processes

    @staticmethod
    def _shard_draw(keys: trandom.ThreefryKey, sl: slice,
                    view: PermutationEngine) -> torch.Tensor:
        """The permutations of a shard's slice of ``keys``, drawn once on
        its device for every cohort."""
        return trandom.permutation(
            trandom.ThreefryKey(keys.words[sl]).to(view.device),
            view._pool_dev)

    def _chunk(self, keys: trandom.ThreefryKey) -> list:
        """Per-bucket ``(T, C, K, 7)`` null statistics: one permutation
        draw per shard, every cohort's null body over the shared index
        blocks; on a mesh that spans processes, host arrays allgathered
        from every process's shards."""
        shards = []
        for sl, views in self._plans():
            perm = self._shard_draw(keys, sl, views[0])
            shards.append([torch.stack(outs).to(self.device) for outs in
                           zip(*(v._values(perm) for v in views))])
        outs = [torch.cat(per_b, dim=1) for per_b in zip(*shards)]
        if self._spans_processes():
            return distributed.gather_to_host(outs, axis=1)
        return outs

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
        (:meth:`PermutationEngine.rebucket`; each cohort drops its shard
        views with its buckets, so the next chunk's plans hold only the
        survivors)."""
        for c in self.cohorts:
            c.rebucket(active)

    def run_key(self) -> str:
        """The single-test engine's key with the cohort count."""
        return self.cohorts[0].run_key() + f"|T:{self.T}"

    _hooks = PermutationEngine._hooks
    record_stream_throughput = PermutationEngine.record_stream_throughput

    def release(self) -> None:
        """Drop every cohort's device tensors
        (:meth:`PermutationEngine.release`); the engine is unusable
        afterwards."""
        for c in self.cohorts:
            c.release()

    def _null_write(self) -> Callable:
        def write(nulls, outs, done, take):
            for b, o in zip(self.buckets, outs):
                if isinstance(o, torch.Tensor):
                    o = o[:, :take].cpu().numpy()
                nulls[:, done: done + take, b.module_pos] = (
                    o[:, :take].astype(np.float64))

        return write

    # ------------------------------------------------------------------
    # Null runs
    # ------------------------------------------------------------------

    def run_null(self, n_perm: int, key=0,
                 progress: Callable[[int, int], None] | None = None,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 8192, observed=None,
                 fault_policy=None, telemetry=None, profile=None,
                 ) -> tuple[np.ndarray, int]:
        """``(nulls, completed)`` with ``nulls`` ``(T, n_perm, n_modules,
        7)`` float64; same key ⇒ cohort t's null equals the single-test
        engine's on cohort t. Checkpoints, fault policy, telemetry and
        profile as :meth:`PermutationEngine.run_null`, the permutation
        axis second. ``observed`` is accepted for the single-test
        signature and not read: this engine never screens."""
        del observed
        key = root_key(key, self.device)
        return run_checkpointed_chunks(
            key, n_perm, self.effective_chunk(), self._chunk,
            self._null_write(), (self.T, n_perm, self.n_modules, N_STATS),
            progress,
            checkpointer(self, key, checkpoint_path, checkpoint_every,
                         self._fingerprint_extra()),
            perm_axis=1, full=self.mesh is not None,
            **self._hooks(fault_policy, telemetry, profile),
        )

    def _stream_parts(self, observed):
        """``(count(keys, valid, acc), pull(acc), tallies)`` over the shared
        draw (:meth:`PermutationEngine._stream_parts`): each shard keeps
        every cohort's tallies on its device, gated by the validity mask
        offset by its slice's first column, and ``pull`` reads each
        shard's in one copy and sums them (across processes too, in
        int64)."""
        observed = np.asarray(observed, dtype=np.float64).reshape(
            self.T, self.n_modules, N_STATS
        )
        plans = self._plans()
        obs = [[v._obs_buckets(observed[t]) for t, v in enumerate(views)]
               for _sl, views in plans]

        def count(keys, valid, acc):
            for s, (sl, views) in enumerate(plans):
                start, stop, _ = sl.indices(keys.words.shape[0])
                own = max(0, min(stop, valid) - start)
                perm = self._shard_draw(keys, sl, views[0])
                for v, ob, t in zip(views, obs[s], acc.dev[s]):
                    v._count(perm, own, ob, t)
            return acc

        def pull(acc):
            total = sum(
                np.stack(pull_tallies(
                    [(v.buckets, t) for v, t in zip(views, tal)],
                    self.n_modules), axis=1)
                for (_sl, views), tal in zip(plans, acc.dev))
            if self._spans_processes():
                total = distributed.sum_to_host(total)
            return tuple(total)

        return count, pull, Tallies([[v._zero_tallies() for v in views]
                                     for _sl, views in plans])

    def run_null_streaming(self, n_perm: int, observed, key=0,
                           progress: Callable[[int, int], None] | None = None,
                           checkpoint_path: str | None = None,
                           checkpoint_every: int = 8192,
                           fault_policy=None, telemetry=None, profile=None,
                           ) -> StreamCounts:
        """Exceedance tallies against ``observed`` ``(T, n_modules, 7)``
        over the shared permutation draw: a
        :class:`~netrep_tpu_torch.parallel.engine.StreamCounts` with ``(T,
        n_modules, 7)`` tallies, equal to ``tail_counts`` of
        :meth:`run_null`'s null per cohort."""
        key = root_key(key, self.device)
        K = resolve_stream_superchunk(
            self, self.cohorts[0].autotune_key(f"T{self.T}|superchunk"))
        count, pull, tallies = self._stream_parts(observed)
        (hi, lo, eff), completed = run_stream_superchunks(
            key, n_perm, self.effective_chunk(), K, count, pull, tallies,
            progress,
            checkpointer(self, key, checkpoint_path, checkpoint_every,
                         _STREAM_FP + self._fingerprint_extra()),
            **self._hooks(fault_policy, telemetry, profile),
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
                          fault_policy=None, telemetry=None,
                          ) -> tuple[np.ndarray, int, bool]:
        """Sequential early-stopping variant of :meth:`run_null`
        (:meth:`PermutationEngine.run_null_adaptive`): the ``(T,
        n_modules, 7)`` observed statistics fold into the monitor's cells
        as ``(n_modules, T*7)``, so a module retires only when it is
        decided in every cohort."""
        return self.run_null_monitored(
            n_perm, key, self._monitor(observed, alternative, rule),
            progress=progress, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, fault_policy=fault_policy,
            telemetry=telemetry)

    def run_null_monitored(self, n_perm: int, key, monitor,
                           progress: Callable[[int, int], None] | None = None,
                           checkpoint_path: str | None = None,
                           checkpoint_every: int = 8192,
                           fault_policy=None, telemetry=None,
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
                key, n_perm, self.effective_chunk(), self._chunk,
                self._null_write(),
                (self.T, n_perm, self.n_modules, N_STATS), slice_vals,
                monitor, self.rebucket, progress,
                checkpointer(self, key, checkpoint_path, checkpoint_every,
                             self._fingerprint_extra()),
                perm_axis=1, full=self.mesh is not None,
                **self._hooks(fault_policy, telemetry),
            )
        finally:
            if self.cohorts[0]._buckets_full:
                self.rebucket(range(self.n_modules))

    def run_null_adaptive_streaming(
            self, n_perm: int, observed, key=0, alternative: str = "greater",
            rule=None, progress: Callable[[int, int], None] | None = None,
            checkpoint_path: str | None = None, checkpoint_every: int = 8192,
            fault_policy=None, telemetry=None, profile=None,
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
                key, n_perm, self.effective_chunk(),
                chunk_counts(lambda: self._stream_parts(observed), monitor,
                             to_cells), monitor,
                self.rebucket, progress,
                checkpointer(self, key, checkpoint_path, checkpoint_every,
                             _STREAM_FP + self._fingerprint_extra()),
                **self._hooks(fault_policy, telemetry, profile),
            )
        finally:
            if self.cohorts[0]._buckets_full:
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
