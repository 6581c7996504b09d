"""Permutation-null engine for one dense (discovery, test) dataset pair.

The port of the main path of ``netrep_tpu/parallel/engine.py``'s
``PermutationEngine``:

- modules are bucketed by capacity exactly as there (``ModuleSpec``,
  ``_Bucket``, :meth:`EngineConfig.rounded_cap`), and each bucket's
  discovery-side properties are computed once with the exact ``eigh``
  summary;
- :meth:`PermutationEngine.observed` gathers the observed test submatrices
  and computes the seven statistics with ``eigh``;
- the null draws permutation ``i`` from ``fold_in(key, i)`` (bit-identical
  to the JAX package's, :mod:`netrep_tpu_torch.random`), slices it into
  per-module index blocks (:func:`_idx_blocks`) and runs each bucket
  through the fused-statistics kernel
  (:mod:`netrep_tpu_torch.ops.fused_stats`): :meth:`run_null` keeps the
  ``(n_perm, n_modules, 7)`` null, :meth:`run_null_streaming` only the
  ``(hi, lo, eff)`` exceedance tallies, folded on the device in int32.

Checkpoints, fault handling, telemetry, meshes, the screened and adaptive
nulls are later slices (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from .. import random as trandom
from ..ops import stats as tstats
from ..ops.fused_stats import fused_stats_counts, fused_stats_values
from ..ops.oracle import N_STATS
from ..utils.config import EngineConfig, resolve_device


@dataclasses.dataclass(frozen=True)
class ModuleSpec:
    """One discovery module's overlap bookkeeping: ``disc_idx`` and
    ``test_idx`` are aligned — position i is the same node (by name) in the
    discovery and test datasets."""

    label: str
    disc_idx: np.ndarray
    test_idx: np.ndarray

    @property
    def size(self) -> int:
        return len(self.test_idx)


@dataclasses.dataclass
class _Bucket:
    cap: int
    module_pos: list[int]            # positions in the global module order
    disc: tstats.DiscProps           # (K, cap[, cap]) discovery props
    obs_idx: torch.Tensor            # (K, cap) int32 observed test indices
    slices: list[tuple[int, int]]    # (offset, size) into the permutation
    take: torch.Tensor               # (K, cap) int64 positions for _take_blocks


@dataclasses.dataclass
class StreamCounts:
    """Result of a streaming null: per-(module, statistic) counts of null
    draws ``>=`` / ``<=`` the observed statistic and of valid (non-NaN)
    draws, ``(n_modules, 7)`` int64 each — for the same key, equal to
    ``pvalues.tail_counts`` of the materialized null."""

    hi: np.ndarray
    lo: np.ndarray
    eff: np.ndarray
    completed: int


def _as_f32(a, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from an array or tensor (read-only
    numpy arrays are copied first: torch cannot wrap them)."""
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a).to(device=device, dtype=torch.float32)


def _pad_to(a: np.ndarray, cap: int) -> np.ndarray:
    return np.pad(a, [(0, cap - a.shape[0])])


def _block_positions(cap: int, slices, n_pool: int, device) -> torch.Tensor:
    """``(K, cap)`` positions into ``perm`` padded with one zero column:
    module k reads ``[off, off + size)``, its padded slots read the zero
    column ``n_pool``."""
    pos = np.full((len(slices), cap), n_pool, dtype=np.int64)
    for k, (off, size) in enumerate(slices):
        pos[k, :size] = np.arange(off, off + size)
    return torch.as_tensor(pos, device=device)


def _take_blocks(perm: torch.Tensor, take: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros(perm.shape[:-1] + (1,), dtype=perm.dtype,
                       device=perm.device)
    return torch.cat([perm, zero], dim=-1)[..., take]


def _idx_blocks(perm: torch.Tensor, cap: int, slices) -> torch.Tensor:
    """Slice one bucket's per-module index sets out of drawn permutations
    and zero-pad each to the bucket capacity: ``perm`` ``(..., P)`` →
    ``(..., K, cap)`` — the JAX engine's module-index layout (padded slots
    are masked downstream)."""
    return _take_blocks(
        perm, _block_positions(cap, slices, perm.shape[-1], perm.device)
    )


class PermutationEngine:
    """Permutation-null engine for one (discovery, test) dataset pair.

    Parameters
    ----------
    disc_corr, disc_net : (n_d, n_d) discovery correlation / network.
    disc_data : (n_samples_d, n_d) discovery data, or None (data-less).
    test_corr, test_net : (n_t, n_t) test correlation / network.
    test_data : (n_samples_t, n_t) test data, or None.
    modules : ordered module specs (global module order = this order).
    pool : candidate test-node indices the null draws from.
    config : engine knobs.
    device : where the engine's operands live and its kernels run; None
        means ``"cuda"`` (raises without a card).

    Inputs may be numpy arrays or tensors; they are copied to the device as
    float32.
    """

    def __init__(self, disc_corr, disc_net, disc_data, test_corr, test_net,
                 test_data, modules: Sequence[ModuleSpec], pool,
                 config: EngineConfig = EngineConfig(), device=None):
        dev = resolve_device(device)
        has_data = disc_data is not None and test_data is not None

        def f32(a):
            return _as_f32(a, dev)

        modules = list(modules)
        sizes = [m.size for m in modules]
        if min(sizes, default=1) < 2:
            bad = [m.label for m in modules if m.size < 2]
            raise ValueError(
                f"modules {bad} have fewer than 2 nodes present in the test "
                "dataset; preservation statistics are undefined"
            )
        pool = np.asarray(pool, dtype=np.int32)
        if int(np.sum(sizes)) > pool.size:
            raise ValueError(
                f"module sizes (total {int(np.sum(sizes))}) exceed the null "
                f"candidate pool ({pool.size}); use null='all' or drop "
                "modules"
            )
        dc, dn = f32(disc_corr), f32(disc_net)
        dd = f32(disc_data) if has_data else None
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        by_cap: dict[int, list[int]] = {}
        for k, m in enumerate(modules):
            by_cap.setdefault(config.rounded_cap(m.size), []).append(k)

        buckets = []
        for cap in sorted(by_cap):
            pos = by_cap[cap]
            didx = torch.as_tensor(np.stack(
                [_pad_to(modules[k].disc_idx.astype(np.int64), cap)
                 for k in pos]
            ), device=dev)
            mask = np.zeros((len(pos), cap), np.float32)
            for r, k in enumerate(pos):
                mask[r, : modules[k].size] = 1.0
            data_b = (
                dd[:, didx].permute(1, 0, 2) if dd is not None else None
            )
            disc = tstats.make_disc_props(
                tstats.gather_submatrix(dc, didx),
                tstats.gather_submatrix(dn, didx),
                data_b, torch.as_tensor(mask, device=dev),
            )
            buckets.append(dict(
                cap=cap, module_pos=pos, disc=disc,
                obs_idx=np.stack([_pad_to(modules[k].test_idx, cap)
                                  for k in pos]),
                slices=[(int(offsets[k]), modules[k].size) for k in pos],
            ))
        # the test data is kept TRANSPOSED, (n, n_samples): a module's data
        # slice is then a gather of contiguous rows
        self._setup(
            f32(test_corr), f32(test_net),
            f32(test_data).T if has_data else None,
            pool, buckets, len(modules), config, dev,
        )
        self.modules = modules

    @classmethod
    def from_parts(cls, test_corr, test_net, test_dataT, pool, buckets,
                   n_modules: int, config: EngineConfig = EngineConfig(),
                   device=None) -> "PermutationEngine":
        """An engine from its device operands directly (see
        :mod:`netrep_tpu_torch.state`): ``buckets`` is a list of dicts with
        ``cap``, ``module_pos``, ``disc`` (:class:`DiscProps`), ``obs_idx``
        ``(K, cap)`` and ``slices``."""
        self = cls.__new__(cls)
        dev = resolve_device(device)

        def f32(a):
            return _as_f32(a, dev)

        self._setup(
            f32(test_corr), f32(test_net),
            None if test_dataT is None else f32(test_dataT),
            np.asarray(pool, dtype=np.int32),
            [dict(b, disc=tstats.DiscProps(*(f32(a) for a in b["disc"])))
             for b in buckets],
            n_modules, config, dev,
        )
        self.modules = None
        return self

    def _setup(self, tc, tn, tdT, pool, buckets, n_modules, config, dev):
        self.config = config
        self.device = dev
        self.n_modules = int(n_modules)
        self._test_corr = tc.contiguous()
        self._test_net = tn.contiguous()
        self._test_dataT = None if tdT is None else tdT.contiguous()
        self.has_data = tdT is not None
        self.pool = pool
        self._pool_dev = torch.as_tensor(pool, device=dev)
        self.buckets = [
            _Bucket(
                cap=int(b["cap"]),
                module_pos=[int(p) for p in b["module_pos"]],
                disc=b["disc"],
                obs_idx=torch.as_tensor(
                    np.array(b["obs_idx"], dtype=np.int32), device=dev
                ),
                slices=[(int(o), int(s)) for o, s in b["slices"]],
                take=_block_positions(int(b["cap"]), b["slices"], pool.size,
                                      dev),
            )
            for b in buckets
        ]

    # ------------------------------------------------------------------
    # Observed statistics
    # ------------------------------------------------------------------

    def observed(self) -> np.ndarray:
        """(n_modules, 7) observed statistics on the actual overlap sets,
        with the exact ``eigh`` summary."""
        out = np.full((self.n_modules, N_STATS), np.nan)
        for b in self.buckets:
            res = tstats.gather_and_stats(
                b.disc, b.obs_idx, self._test_corr, self._test_net,
                self._test_dataT, n_iter=self.config.power_iters,
                summary_method="eigh",
            )
            out[b.module_pos] = res.cpu().numpy().astype(np.float64)
        return out

    # ------------------------------------------------------------------
    # Null chunks
    # ------------------------------------------------------------------

    def _root_key(self, key) -> trandom.ThreefryKey:
        if isinstance(key, trandom.ThreefryKey):
            return key.to(self.device)
        return trandom.key(int(key), device=self.device)

    def _bucket_idx(self, perm: torch.Tensor, b: _Bucket) -> torch.Tensor:
        return _take_blocks(perm, b.take).to(torch.int32).contiguous()

    def _chunk(self, keys: trandom.ThreefryKey) -> list[torch.Tensor]:
        """One chunk of the materialized null: per-bucket ``(C, K, 7)``
        statistics for the permutations drawn from ``keys``, one kernel
        launch per bucket."""
        perm = trandom.permutation(keys, self._pool_dev)
        return [
            fused_stats_values(
                self._test_corr, self._test_net, self._test_dataT,
                b.disc, self._bucket_idx(perm, b),
                n_iter=self.config.power_iters,
            )
            for b in self.buckets
        ]

    def _count_chunk(self, keys: trandom.ThreefryKey, valid: int,
                     obs: list[torch.Tensor], tallies) -> None:
        """One chunk of the streaming null: adds the per-bucket int32 ``(hi,
        lo, eff)`` tallies of the first ``valid`` permutations of ``keys``
        into ``tallies`` (the rest are gated off by ``pvalid``), one kernel
        launch per bucket."""
        perm = trandom.permutation(keys, self._pool_dev)
        pvalid = (torch.arange(keys.shape[0], device=self.device)
                  < valid).to(torch.int32)
        for b, ob, acc in zip(self.buckets, obs, tallies):
            _v, *counts = fused_stats_counts(
                self._test_corr, self._test_net, self._test_dataT,
                b.disc, self._bucket_idx(perm, b), pvalid, ob,
                n_iter=self.config.power_iters,
            )
            for t, d in zip(acc, counts):
                t += d

    def run_null(self, n_perm: int, key=0,
                 progress: Callable[[int, int], None] | None = None,
                 ) -> tuple[np.ndarray, int]:
        """The materialized permutation null: ``(nulls, completed)`` with
        ``nulls`` ``(n_perm, n_modules, 7)`` float64. ``key`` is an integer
        seed or a :class:`~netrep_tpu_torch.random.ThreefryKey`; the same
        key gives the same null regardless of chunk size. ``progress(done,
        total)`` is called after each chunk lands on the host. Chunk k+1 is
        enqueued before chunk k is copied back, so the device works while
        the host waits on the copy."""
        key = self._root_key(key)
        C = self.config.chunk_size
        nulls = np.full((n_perm, self.n_modules, N_STATS), np.nan)
        pending = None
        completed = 0
        starts = list(range(0, n_perm, C)) + [None]
        for start in starts:
            nxt = None
            if start is not None:
                take = min(C, n_perm - start)
                nxt = (self._chunk(trandom.perm_keys(key, start, take)),
                       start, take)
            if pending is not None:
                outs, at, take_p = pending
                for b, o in zip(self.buckets, outs):
                    nulls[at: at + take_p, b.module_pos] = (
                        o.cpu().numpy().astype(np.float64)
                    )
                completed = at + take_p
                if progress is not None:
                    progress(completed, n_perm)
            pending = nxt
        return nulls, completed

    def run_null_streaming(self, n_perm: int, observed: np.ndarray, key=0,
                           progress: Callable[[int, int], None] | None = None,
                           ) -> StreamCounts:
        """The streaming permutation null: exceedance tallies against
        ``observed`` ``(n_modules, 7)``, accumulated on the device in int32
        over ``config.superchunk`` chunks between host reads. Chunk j of a
        superchunk starting at ``done`` draws ``fold_in(key, done + j*C +
        i)`` — the permutations :meth:`run_null` draws at the same indices —
        and the tail is gated per permutation, so the tallies equal
        ``tail_counts`` of :meth:`run_null`'s null for the same key."""
        key = self._root_key(key)
        C = self.config.chunk_size
        K = self.config.resolved_superchunk
        obs = [
            torch.as_tensor(np.asarray(observed)[b.module_pos],
                            dtype=torch.float32, device=self.device)
            for b in self.buckets
        ]
        tallies = [
            [torch.zeros((len(b.module_pos), N_STATS), dtype=torch.int32,
                         device=self.device) for _ in range(3)]
            for b in self.buckets
        ]
        hi = lo = eff = np.zeros((self.n_modules, N_STATS), np.int64)
        completed = 0
        while completed < n_perm:
            take = min(K * C, n_perm - completed)
            for j in range(K):
                valid = min(C, n_perm - completed - j * C)
                if valid <= 0:
                    break
                self._count_chunk(
                    trandom.perm_keys(key, completed + j * C, C), valid, obs,
                    tallies,
                )
            completed += take
            hi, lo, eff = self._pull_tallies(tallies)
            if progress is not None:
                progress(completed, n_perm)
        return StreamCounts(hi=hi, lo=lo, eff=eff, completed=completed)

    def _pull_tallies(self, tallies) -> tuple:
        out = [np.zeros((self.n_modules, N_STATS), np.int64) for _ in range(3)]
        for b, acc in zip(self.buckets, tallies):
            for o, t in zip(out, acc):
                o[b.module_pos] = t.cpu().numpy()
        return tuple(out)
