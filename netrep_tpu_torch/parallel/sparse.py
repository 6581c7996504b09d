"""Sparse permutation engine — Config E: permutation nulls over kNN-graph
adjacencies without an ``n × n`` matrix.

The port of ``netrep_tpu/parallel/sparse.py``'s ``SparsePermutationEngine``:
the dense engine's contract (capacity buckets, the chunked, interruptible,
checkpointable null loop, chunk- and mesh-independent permutations) on
another data plane — padded neighbour lists and correlations computed on
the fly (:mod:`netrep_tpu_torch.ops.sparse`). The chunk draws permutation
``i`` from ``fold_in(key, i)`` as the dense engine does, slices each
bucket's module index sets out of it zero-padded (padded slots read node
0, masked downstream) and computes the seven statistics batched over
(permutation, module). No kernel of the port runs on this path, as no
Pallas kernel runs on the JAX package's.

Checkpoints: the JAX engine's fingerprint digests its device arrays,
the discovery properties among them, whose ``eigh``-derived values the
port reproduces only to float32 rounding. The port's fingerprint digests
the original inputs instead (:meth:`SparsePermutationEngine.
fingerprint_digest`), so a resumed sparse run equals the uninterrupted
one within the port, and the JAX package's sparse checkpoint is refused
with its fingerprint-mismatch error.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from .. import random as trandom
from ..ops import sparse as tsparse
from ..ops import stats as tstats
from ..ops.oracle import N_STATS
from ..ops.sparse import SparseAdjacency
from ..utils import checkpoint as ckpt
from ..utils.config import EngineConfig
from . import mesh as tmesh
from .engine import (
    ModuleSpec, _as_f32, _block_positions, _Bucket, _take_blocks,
    checkpointer, root_key, run_checkpointed_chunks,
)
from .mesh import PERM_AXIS, Mesh
from .sharded import chunk_shards


def _ids(a: np.ndarray, dev) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


class SparsePermutationEngine:
    """Permutation-null engine for one (discovery, test) pair of sparse
    networks.

    Parameters
    ----------
    disc_adj, test_adj : :class:`~netrep_tpu_torch.ops.sparse.
        SparseAdjacency`.
    disc_data, test_data : ``(n_samples, n)`` data or None. Without data a
        precomputed sparse correlation (``disc_corr``/``test_corr``) keeps
        four statistics finite; with neither only avg.weight and
        cor.degree are defined.
    modules : ordered :class:`ModuleSpec` list.
    pool : candidate test-node ids the null draws from.
    config : engine knobs (``chunk_size``, ``summary_method``,
        ``power_iters``, bucket rounding); ``matrix_sharding='row'``
        raises the JAX package's ``NotImplementedError``.
    device : where the engine's operands live; None means ``"cuda"``
        (raises without a card).
    mesh : optional :class:`~netrep_tpu_torch.parallel.mesh.Mesh`; a
        chunk splits over its ``perm`` axis, the neighbour lists
        (``O(n·k)``) replicated on each shard's device.
    disc_corr, test_corr : optional PRECOMPUTED sparse correlations in the
        same format; they feed the correlation statistics instead of the
        on-the-fly ``zᵀz``.
    """

    def __init__(self, disc_adj: SparseAdjacency, disc_data,
                 test_adj: SparseAdjacency, test_data,
                 modules: Sequence[ModuleSpec], pool,
                 config: EngineConfig = EngineConfig(), device=None,
                 mesh: Mesh | None = None,
                 disc_corr: SparseAdjacency | None = None,
                 test_corr: SparseAdjacency | None = None):
        if config.matrix_sharding == "row":
            raise NotImplementedError(
                "matrix_sharding='row' does not apply to the sparse engine: "
                "the padded neighbor lists are O(n·k) and are replicated"
            )
        dev = tmesh.resolve_device(mesh, device)
        self.config = config
        self.device = dev
        self.mesh = mesh
        self.modules = list(modules)
        self.n_modules = len(self.modules)
        self.has_data = disc_data is not None and test_data is not None

        bad = [m.label for m in self.modules if m.size < 2]
        if bad:
            raise ValueError(
                f"modules {bad} have fewer than 2 nodes present in the test "
                "dataset; drop them before building the engine"
            )
        if (disc_corr is None) != (test_corr is None):
            raise ValueError(
                "provide both disc_corr and test_corr sparse correlations, "
                "or neither"
            )
        self.has_corr = disc_corr is not None
        if self.has_corr:
            for what, c, adj in (("disc", disc_corr, disc_adj),
                                 ("test", test_corr, test_adj)):
                if not isinstance(c, SparseAdjacency) or c.n != adj.n:
                    raise ValueError(
                        f"{what}_corr must be a SparseAdjacency over the "
                        f"same {adj.n} nodes as the {what} network"
                    )
        self.pool = np.asarray(pool, dtype=np.int32)
        self.total_take = sum(m.size for m in self.modules)
        if self.total_take > self.pool.size:
            raise ValueError(
                f"total module size ({self.total_take}) exceeds the "
                f"candidate pool ({self.pool.size}); use null='all' or drop "
                "modules"
            )
        # the checkpoint identity: the original inputs (module docstring)
        self._digest = ckpt.content_digest([
            disc_adj.nbr, disc_adj.wgt,
            disc_data if self.has_data else None,
            test_adj.nbr, test_adj.wgt,
            test_data if self.has_data else None,
            *((disc_corr.nbr, disc_corr.wgt, test_corr.nbr, test_corr.wgt)
              if self.has_corr else (None,) * 4),
        ])

        def dataT(d):
            # transposed, (n, s): a module's data slice is a row gather
            return _as_f32(d, dev).T.contiguous() if self.has_data else None

        self._nbr, self._wgt = _ids(test_adj.nbr, dev), _as_f32(
            test_adj.wgt, dev)
        self._test_dataT = dataT(test_data)
        self._cnbr = self._cwgt = None
        if self.has_corr:
            self._cnbr = _ids(test_corr.nbr, dev)
            self._cwgt = _as_f32(test_corr.wgt, dev)
        self._pool_dev = torch.as_tensor(self.pool, device=dev)

        # discovery side, once: bucket by padded capacity
        d_nbr, d_wgt = _ids(disc_adj.nbr, dev), _as_f32(disc_adj.wgt, dev)
        d_cnbr = _ids(disc_corr.nbr, dev) if self.has_corr else None
        d_cwgt = _as_f32(disc_corr.wgt, dev) if self.has_corr else None
        d_dataT = dataT(disc_data)
        by_cap: dict[int, list[int]] = {}
        for k, m in enumerate(self.modules):
            by_cap.setdefault(config.rounded_cap(m.size), []).append(k)
        offsets = np.concatenate(
            [[0], np.cumsum([m.size for m in self.modules])]).astype(int)
        self.buckets: list[_Bucket] = []
        for cap, pos in sorted(by_cap.items()):
            disc_idx = np.zeros((len(pos), cap), dtype=np.int32)
            obs_idx = np.zeros((len(pos), cap), dtype=np.int32)
            mask = np.zeros((len(pos), cap), dtype=np.float32)
            slices = []
            for row, k in enumerate(pos):
                m = self.modules[k]
                disc_idx[row, :m.size] = np.asarray(m.disc_idx)
                obs_idx[row, :m.size] = np.asarray(m.test_idx)
                mask[row, :m.size] = 1.0
                slices.append((int(offsets[k]), m.size))
            disc = tsparse.make_disc_props_sparse(
                d_nbr, d_wgt, d_dataT, _ids(disc_idx, dev),
                torch.as_tensor(mask, device=dev),
                corr_nbr=d_cnbr, corr_wgt=d_cwgt)
            self.buckets.append(_Bucket(
                cap=cap, module_pos=pos, disc=disc,
                obs_idx=_ids(obs_idx, dev), slices=slices,
                take=_block_positions(cap, slices, self.pool.size, dev)))
        self._shards = None

    def effective_chunk(self) -> int:
        """Chunk size, rounded to a multiple of the mesh's ``perm`` axis
        (the dense engine's rule)."""
        C = self.config.chunk_size
        if self.mesh is not None:
            ax = self.mesh.shape[PERM_AXIS]
            C = max(ax, (C // ax) * ax)
        return C

    def fingerprint_digest(self) -> str:
        """Content digest of the original inputs — both networks, data and
        correlations — part of the checkpoint identity (module
        docstring)."""
        return self._digest

    def _stats(self, b: _Bucket, idx,
               summary_method: str | None = None) -> torch.Tensor:
        return tsparse.sparse_gather_and_stats(
            b.disc, idx, self._nbr, self._wgt, self._test_dataT,
            self._cnbr, self._cwgt, n_iter=self.config.power_iters,
            summary_method=summary_method or self.config.summary_method)

    def observed(self) -> np.ndarray:
        """(n_modules, 7) observed statistics on the actual overlap sets,
        with the exact ``eigh`` summary."""
        out = np.full((self.n_modules, N_STATS), np.nan)
        for b in self.buckets:
            res = self._stats(b, b.obs_idx, summary_method="eigh")
            out[b.module_pos] = res.cpu().numpy().astype(np.float64)
        return out

    def _values(self, perm: torch.Tensor) -> list[torch.Tensor]:
        """Per-bucket ``(C, K, 7)`` null statistics of the drawn
        permutations ``perm`` ``(C, P)``: each bucket's module index sets,
        zero-padded to its capacity, batched over (permutation, module)."""
        return [self._stats(b, _take_blocks(perm, b.take))
                for b in self.buckets]

    def _on(self, dev, placed: dict) -> "SparsePermutationEngine":
        """A mesh-free view of this engine on ``dev``: every operand there,
        one copy per device (``placed`` keeps them)."""
        view = copy.copy(self)
        view.mesh, view.device, view._shards = None, dev, None

        def mv(a):
            if a is None:
                return None
            if (id(a), dev) not in placed:
                placed[(id(a), dev)] = a.to(dev)
            return placed[(id(a), dev)]

        for name in ("_nbr", "_wgt", "_test_dataT", "_cnbr", "_cwgt",
                     "_pool_dev"):
            setattr(view, name, mv(getattr(self, name)))
        view.buckets = [
            dataclasses.replace(b, disc=tstats.DiscProps(*map(mv, b.disc)),
                                obs_idx=mv(b.obs_idx), take=mv(b.take))
            for b in self.buckets
        ]
        return view

    def _chunk(self, keys: trandom.ThreefryKey) -> list[torch.Tensor]:
        """One chunk: the drawn permutations' statistics per bucket; on a
        mesh each perm shard draws and computes its slice of ``keys`` on
        its device (:func:`~netrep_tpu_torch.parallel.sharded.
        chunk_shards`), gathered back in order."""
        if self.mesh is None:
            return self._values(trandom.permutation(keys, self._pool_dev))
        if self._shards is None:
            placed: dict = {}
            self._shards = [
                (sl, self._on(self.mesh.devices[p, r], placed))
                for p, r, sl in chunk_shards(self.mesh,
                                             self.effective_chunk(), False)
            ]
        parts = [
            eng._values(trandom.permutation(
                trandom.ThreefryKey(keys.words[sl]).to(eng.device),
                eng._pool_dev))
            for sl, eng in self._shards
        ]
        return [torch.cat([p[i].to(self.device) for p in parts])
                for i in range(len(self.buckets))]

    def run_null(self, n_perm: int, key=0,
                 progress: Callable[[int, int], None] | None = None,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 8192) -> tuple[np.ndarray, int]:
        """The materialized null, as
        :meth:`~netrep_tpu_torch.parallel.engine.PermutationEngine.run_null`:
        ``(nulls, completed)``, chunked, interruptible, resumable (within
        the port: module docstring); the same key gives the same null at
        every chunk size and mesh."""
        key = root_key(key, self.device)

        def write(nulls, outs, at, take):
            for b, o in zip(self.buckets, outs):
                nulls[at: at + take, b.module_pos] = (
                    o[:take].cpu().numpy().astype(np.float64))

        return run_checkpointed_chunks(
            key, n_perm, self.effective_chunk(), self._chunk, write,
            (n_perm, self.n_modules, N_STATS), progress,
            checkpointer(self, key, checkpoint_path, checkpoint_every),
            full=self.mesh is not None,
        )
