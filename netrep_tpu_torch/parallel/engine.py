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
  to the JAX package's, :mod:`netrep_tpu_torch.random`) and slices it into
  per-module index blocks (:func:`_idx_blocks`; padded slots read node 0
  and are masked downstream). Each bucket then runs
  either through the fused-statistics kernel
  (:mod:`netrep_tpu_torch.ops.fused_stats`, ``stat_mode='fused'``) or
  through the composed statistics (``stat_mode='xla'``): the test
  correlation and network submatrices gathered by the gather kernel
  (:mod:`netrep_tpu_torch.ops.fused_gather`, whose plain version runs for
  CPU tensors), the standardized data slice, then
  ``module_stats_masked`` batched over (permutation, module).
  :meth:`run_null` keeps the ``(n_perm, n_modules, 7)`` null,
  :meth:`run_null_streaming` only the ``(hi, lo, eff)`` exceedance
  tallies, folded on the device in int32;
- with ``network_from_correlation`` the engine stores no test network:
  network submatrices derive from the gathered correlation
  (:func:`check_derived_network` first checks the supplied networks).

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
from ..ops.fused_gather import gather_submatrix_fused
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


#: formula of each derived-network kind, for error texts
DERIVED_FORMULA = {
    "unsigned": "|correlation|**{b}",
    "signed": "((1+correlation)/2)**{b}",
    "signed-hybrid": "max(correlation, 0)**{b}",
}


def _flat_sample(a, ii) -> np.ndarray:
    """``a.reshape(-1)[ii]`` (all of it for ``ii`` None) as a host array,
    sampled where ``a`` lives so a matrix on the card is not copied
    whole."""
    if isinstance(a, torch.Tensor):
        flat = a.reshape(-1)
        if ii is not None:
            flat = flat[torch.as_tensor(ii, device=a.device)]
        return flat.cpu().numpy()
    flat = np.asarray(a).reshape(-1)
    return flat if ii is None else flat[ii]


def check_derived_network(corr, net, net_beta, what: str) -> None:
    """Check that ``net`` is the claimed soft-threshold construction of
    ``corr`` before the engine commits to deriving network submatrices
    (``EngineConfig.network_from_correlation``): every entry of a matrix of
    up to 65,536 entries, else the same fixed-seed random flat sample of
    65,536 entries as the JAX package. The expected values come from
    :func:`~netrep_tpu_torch.ops.stats.derived_net` itself, in float32 on
    the host. A mismatch raises the JAX package's ``ValueError``."""
    beta, kind = tstats.normalize_net_beta(net_beta)
    size = int(np.prod(np.shape(corr)))
    ii = None
    if size > 65536:
        ii = np.random.default_rng(0).integers(0, size, size=65536)
    c, m = _flat_sample(corr, ii), _flat_sample(net, ii)
    want = tstats.derived_net(torch.as_tensor(c, dtype=torch.float32),
                              net_beta).numpy()
    if not np.allclose(m, want, rtol=1e-3, atol=1e-4):
        worst = float(np.max(np.abs(m - want)))
        formula = DERIVED_FORMULA[kind].format(b=beta)
        raise ValueError(
            f"network_from_correlation={net_beta!r} but the supplied {what} "
            f"network is not {formula} (max sampled deviation "
            f"{worst:.3g}); drop the config knob or fix the inputs"
        )


def count_buckets(outs, obs, mask):
    """Per-bucket exceedance tallies of one chunk: compare each ``(C, K,
    7)`` output with the observed ``(K, 7)`` statistics and sum the
    permutation axis into ``(hi, lo, eff)`` int32 counts, counting only the
    permutations ``mask`` (bool, ``(C,)``) keeps. Comparisons run float32
    against float32 on the very values the materialized null widens to
    float64 (exactly) and NaN compares False, so the counts equal
    ``tail_counts`` of the materialized rows bit for bit (the JAX package's
    ``make_count_buckets``)."""
    sel = mask[:, None, None]
    return [
        (((o >= ob) & sel).sum(0, dtype=torch.int32),
         ((o <= ob) & sel).sum(0, dtype=torch.int32),
         ((~torch.isnan(o)) & sel).sum(0, dtype=torch.int32))
        for o, ob in zip(outs, obs)
    ]


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


def build_buckets(disc_corr, disc_net, disc_data, modules, pool,
                  config: EngineConfig, dev) -> list[dict]:
    """Bucket the modules by capacity and compute each bucket's
    discovery-side properties (exact ``eigh`` summary): the buckets
    :meth:`PermutationEngine.from_parts` takes. Raises on a module with
    fewer than two nodes or module sizes beyond the pool. With
    ``config.network_from_correlation`` the discovery network submatrices
    derive from the gathered correlation and ``disc_net`` is not read."""
    modules = list(modules)
    sizes = [m.size for m in modules]
    if min(sizes, default=1) < 2:
        bad = [m.label for m in modules if m.size < 2]
        raise ValueError(
            f"modules {bad} have fewer than 2 nodes present in the test "
            "dataset; preservation statistics are undefined"
        )
    if int(np.sum(sizes)) > np.size(pool):
        raise ValueError(
            f"module sizes (total {int(np.sum(sizes))}) exceed the null "
            f"candidate pool ({np.size(pool)}); use null='all' or drop "
            "modules"
        )
    net_beta = config.network_from_correlation
    dc = _as_f32(disc_corr, dev)
    dn = None if net_beta is not None else _as_f32(disc_net, dev)
    dd = None if disc_data is None else _as_f32(disc_data, dev)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    by_cap: dict[int, list[int]] = {}
    for k, m in enumerate(modules):
        by_cap.setdefault(config.rounded_cap(m.size), []).append(k)

    buckets = []
    for cap in sorted(by_cap):
        pos = by_cap[cap]
        didx = torch.as_tensor(np.stack(
            [_pad_to(modules[k].disc_idx.astype(np.int64), cap) for k in pos]
        ), device=dev)
        mask = np.zeros((len(pos), cap), np.float32)
        for r, k in enumerate(pos):
            mask[r, : modules[k].size] = 1.0
        sub_c = tstats.gather_submatrix(dc, didx)
        disc = tstats.make_disc_props(
            sub_c,
            tstats.derived_net(sub_c, net_beta) if dn is None
            else tstats.gather_submatrix(dn, didx),
            dd[:, didx].permute(1, 0, 2) if dd is not None else None,
            torch.as_tensor(mask, device=dev),
        )
        buckets.append(dict(
            cap=cap, module_pos=pos, disc=disc,
            obs_idx=np.stack([_pad_to(modules[k].test_idx, cap)
                              for k in pos]),
            slices=[(int(offsets[k]), modules[k].size) for k in pos],
        ))
    return buckets


def _run_chunks(key, n_perm: int, C: int, chunk: Callable, write: Callable,
                progress) -> int:
    """The materialized null loop: ``chunk(keys)`` for permutations
    ``[start, start + C)``, ``write(outs, start, take)`` once they land.
    Chunk k+1 is enqueued before chunk k is copied back, so the device
    works while the host waits on the copy."""
    pending = None
    completed = 0
    for start in list(range(0, n_perm, C)) + [None]:
        nxt = None
        if start is not None:
            take = min(C, n_perm - start)
            nxt = (chunk(trandom.perm_keys(key, start, take)), start, take)
        if pending is not None:
            outs, at, take_p = pending
            write(outs, at, take_p)
            completed = at + take_p
            if progress is not None:
                progress(completed, n_perm)
        pending = nxt
    return completed


def _run_stream(key, n_perm: int, C: int, K: int, count: Callable,
                pull: Callable, progress):
    """The streaming null loop: ``count(keys, valid)`` folds chunk tallies
    on the device; ``pull()`` reads them to the host once per superchunk of
    ``K`` chunks. Chunk j of a superchunk starting at ``done`` draws
    ``fold_in(key, done + j*C + i)`` — the permutations the materialized
    loop draws at the same indices — and its tail past ``n_perm`` is gated
    off. Returns ``(pull(), completed)``."""
    counts = pull()
    completed = 0
    while completed < n_perm:
        take = min(K * C, n_perm - completed)
        for j in range(K):
            valid = min(C, n_perm - completed - j * C)
            if valid <= 0:
                break
            count(trandom.perm_keys(key, completed + j * C, C), valid)
        completed += take
        counts = pull()
        if progress is not None:
            progress(completed, n_perm)
    return counts, completed


def root_key(key, device) -> trandom.ThreefryKey:
    """A :class:`~netrep_tpu_torch.random.ThreefryKey` on ``device`` from
    an integer seed or a key."""
    if isinstance(key, trandom.ThreefryKey):
        return key.to(device)
    return trandom.key(int(key), device=device)


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
    config : engine knobs (``stat_mode`` and ``network_from_correlation``
        choose the null's path).
    device : where the engine's operands live and its kernels run; None
        means ``"cuda"`` (raises without a card).

    Inputs may be numpy arrays or tensors; they are copied to the device as
    float32. With ``config.network_from_correlation`` both networks are
    checked against the construction (:func:`check_derived_network`) and
    only the correlations are kept.
    """

    def __init__(self, disc_corr, disc_net, disc_data, test_corr, test_net,
                 test_data, modules: Sequence[ModuleSpec], pool,
                 config: EngineConfig = EngineConfig(), device=None):
        dev = resolve_device(device)
        modules = list(modules)
        has_data = disc_data is not None and test_data is not None
        net_beta = config.network_from_correlation
        if net_beta is not None:
            check_derived_network(disc_corr, disc_net, net_beta, "discovery")
            check_derived_network(test_corr, test_net, net_beta, "test")
        pool = np.asarray(pool, dtype=np.int32)
        buckets = build_buckets(disc_corr, disc_net,
                                disc_data if has_data else None, modules,
                                pool, config, dev)
        # the test data is kept TRANSPOSED, (n, n_samples): a module's data
        # slice is then a gather of contiguous rows
        self._setup(
            _as_f32(test_corr, dev),
            None if net_beta is not None else _as_f32(test_net, dev),
            _as_f32(test_data, dev).T if has_data else None,
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
        ``(K, cap)`` and ``slices``. ``test_net`` is not read when
        ``config.network_from_correlation`` is set."""
        self = cls.__new__(cls)
        dev = resolve_device(device)

        def f32(a):
            return _as_f32(a, dev)

        derived = config.network_from_correlation is not None
        self._setup(
            f32(test_corr), None if derived or test_net is None
            else f32(test_net),
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
        self.net_beta = config.network_from_correlation
        if tn is None and self.net_beta is None:
            raise ValueError(
                "test_net is None but network_from_correlation is not set"
            )
        self.stat_mode = config.resolved_stat_mode()
        self.n_modules = int(n_modules)
        self._test_corr = tc.contiguous()
        self._test_net = None if tn is None else tn.contiguous()
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
                summary_method="eigh", net_beta=self.net_beta,
            )
            out[b.module_pos] = res.cpu().numpy().astype(np.float64)
        return out

    # ------------------------------------------------------------------
    # Null chunks
    # ------------------------------------------------------------------

    def _bucket_idx(self, perm: torch.Tensor, b: _Bucket) -> torch.Tensor:
        return _take_blocks(perm, b.take).to(torch.int32).contiguous()

    def _composed(self, b: _Bucket, idx: torch.Tensor) -> torch.Tensor:
        """The composed statistics of one bucket, ``(C, K, 7)``: gathered
        (or derived) test submatrices, the standardized data slice, then
        ``module_stats_masked`` batched over (C, K) by broadcasting against
        the bucket's ``(K, …)`` discovery properties."""
        sub_c = gather_submatrix_fused(self._test_corr, idx)
        sub_n = (
            tstats.derived_net(sub_c, self.net_beta)
            if self._test_net is None
            else gather_submatrix_fused(self._test_net, idx)
        )
        zd = (
            tstats.gather_zdata(self._test_dataT, idx, b.disc.mask)
            if self.has_data else None
        )
        return tstats.module_stats_masked(
            b.disc, sub_c, sub_n, zd, n_iter=self.config.power_iters,
            summary_method=self.config.summary_method,
        )

    def _values(self, perm: torch.Tensor) -> list[torch.Tensor]:
        """Per-bucket ``(C, K, 7)`` null statistics of the drawn
        permutations ``perm`` ``(C, P)``: one fused-statistics launch per
        bucket, or the composed statistics (one gather launch per bucket
        and stored matrix)."""
        outs = []
        for b in self.buckets:
            idx = self._bucket_idx(perm, b)
            if self.stat_mode == "fused":
                outs.append(fused_stats_values(
                    self._test_corr, self._test_net, self._test_dataT,
                    b.disc, idx, net_beta=self.net_beta,
                    n_iter=self.config.power_iters,
                ))
            else:
                outs.append(self._composed(b, idx))
        return outs

    def _count(self, perm: torch.Tensor, valid: int,
               obs: list[torch.Tensor], tallies) -> None:
        """Add the per-bucket int32 ``(hi, lo, eff)`` tallies of the first
        ``valid`` permutations of ``perm`` into ``tallies`` (the rest are
        gated off): the fused-statistics kernel folds them itself, the
        composed path through :func:`count_buckets`."""
        C = perm.shape[0]
        keep = torch.arange(C, device=self.device) < valid
        if self.stat_mode == "fused":
            pvalid = keep.to(torch.int32)
            deltas = [
                fused_stats_counts(
                    self._test_corr, self._test_net, self._test_dataT,
                    b.disc, self._bucket_idx(perm, b), pvalid, ob,
                    net_beta=self.net_beta, n_iter=self.config.power_iters,
                )[1:]
                for b, ob in zip(self.buckets, obs)
            ]
        else:
            deltas = count_buckets(self._values(perm), obs, keep)
        for acc, d in zip(tallies, deltas):
            for t, x in zip(acc, d):
                t += x

    def _chunk(self, keys: trandom.ThreefryKey) -> list[torch.Tensor]:
        return self._values(trandom.permutation(keys, self._pool_dev))

    def _obs_buckets(self, observed) -> list[torch.Tensor]:
        return [
            torch.as_tensor(np.asarray(observed)[b.module_pos],
                            dtype=torch.float32, device=self.device)
            for b in self.buckets
        ]

    def _zero_tallies(self) -> list:
        return [
            [torch.zeros((len(b.module_pos), N_STATS),
                         dtype=torch.int32, device=self.device)
             for _ in range(3)]
            for b in self.buckets
        ]

    def _pull(self, tallies) -> tuple:
        """Device tallies → ``(n_modules, 7)`` int64 host arrays."""
        out = [np.zeros((self.n_modules, N_STATS), np.int64)
               for _ in range(3)]
        for b, acc in zip(self.buckets, tallies):
            for o, t in zip(out, acc):
                o[b.module_pos] = t.cpu().numpy()
        return tuple(out)

    def run_null(self, n_perm: int, key=0,
                 progress: Callable[[int, int], None] | None = None,
                 ) -> tuple[np.ndarray, int]:
        """The materialized permutation null: ``(nulls, completed)`` with
        ``nulls`` ``(n_perm, n_modules, 7)`` float64. ``key`` is an integer
        seed or a :class:`~netrep_tpu_torch.random.ThreefryKey`; the same
        key gives the same null regardless of chunk size. ``progress(done,
        total)`` is called after each chunk lands on the host."""
        nulls = np.full((n_perm, self.n_modules, N_STATS), np.nan)

        def write(outs, at, take):
            for b, o in zip(self.buckets, outs):
                nulls[at: at + take, b.module_pos] = (
                    o.cpu().numpy().astype(np.float64)
                )

        completed = _run_chunks(root_key(key, self.device), n_perm,
                                self.config.chunk_size, self._chunk, write,
                                progress)
        return nulls, completed

    def run_null_streaming(self, n_perm: int, observed: np.ndarray, key=0,
                           progress: Callable[[int, int], None] | None = None,
                           ) -> StreamCounts:
        """The streaming permutation null: exceedance tallies against
        ``observed`` ``(n_modules, 7)``, accumulated on the device in int32
        over ``config.superchunk`` chunks between host reads. For the same
        key the tallies equal ``tail_counts`` of :meth:`run_null`'s
        null."""
        obs = self._obs_buckets(observed)
        tallies = self._zero_tallies()

        def count(keys, valid):
            self._count(trandom.permutation(keys, self._pool_dev), valid,
                        obs, tallies)

        (hi, lo, eff), completed = _run_stream(
            root_key(key, self.device), n_perm, self.config.chunk_size,
            self.config.resolved_superchunk, count,
            lambda: self._pull(tallies), progress,
        )
        return StreamCounts(hi=hi, lo=lo, eff=eff, completed=completed)
