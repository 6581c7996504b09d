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
  correlation and network submatrices of every bucket gathered by one
  gather-kernel launch per matrix
  (:mod:`netrep_tpu_torch.ops.fused_gather`, whose plain version runs for
  CPU tensors), the standardized data slice, then
  ``module_stats_masked`` batched over (permutation, module).
  :meth:`run_null` keeps the ``(n_perm, n_modules, 7)`` null,
  :meth:`run_null_streaming` only the ``(hi, lo, eff)`` exceedance
  tallies, folded on the device in int32;
- with ``network_from_correlation`` the engine stores no test network:
  network submatrices derive from the gathered correlation
  (:func:`check_derived_network` first checks the supplied networks);
- with a ``mesh`` (:mod:`netrep_tpu_torch.parallel.mesh`) the chunk splits
  over its shards (:func:`~netrep_tpu_torch.parallel.sharded.chunk_shards`)
  and each shard runs on its device, one after another from this process.
  Replicated matrices (``matrix_sharding='replicated'``): each perm shard
  runs the body above on its slice (the JAX package's perm-axis
  ``shard_map``). Row-sharded matrices (``'row'``) are held only as row
  blocks; ``stat_mode='fused'`` then takes the ring path (the chunk splits
  over perm × row, each shard streams the blocks around its ring —
  :func:`~netrep_tpu_torch.ops.fused_stats.ring_gather_all` — and computes
  the composed statistics on its slice), ``'xla'`` the psum path (each
  perm shard's composed body gathers from its row blocks, each block's
  launch writing the rows it owns in place). The observed pass and the
  discovery side of a row-sharded engine gather that way too.

Every null loop takes a checkpoint path (:class:`Checkpointer`): a resumed
run equals the uninterrupted one, at any mesh shape and across packages
(the JAX package's file, key data and fingerprint). The adaptive nulls
(:meth:`PermutationEngine.run_null_adaptive`, ``_streaming``) fold each
chunk into a :class:`~netrep_tpu_torch.ops.sequential.StopMonitor` and
:meth:`~PermutationEngine.rebucket` the engine to the modules still
drawing; the kernels then run on the smaller buckets, each (permutation,
module) cell computed as in the fixed run. Streaming tallies stay int32 on
the device: per chunk at most ``chunk_size`` draws, per run at most
``n_perm`` — far below 2**31 at any ceiling a user runs (100,000).

In data-only mode (all four matrices None) the engine stores no ``n ×
n`` matrix: every submatrix derives from gathered data rows
(:mod:`netrep_tpu_torch.atlas.modules`) through the composed statistics,
as the JAX engine pins it, and every loop above runs it unchanged.

Fault handling, telemetry, the multi-test engine on a mesh and the
screened null are later slices (ROADMAP.md, Queue 1 items 16, 14, 13).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from .. import random as trandom
from ..atlas.modules import (
    data_only_gather_and_stats, make_disc_props_data_only,
)
from ..ops import stats as tstats
from ..ops.fused_gather import gather_submatrix_fused_many
from ..ops.fused_stats import (
    fused_stats_counts, fused_stats_values, ring_gather_all,
)
from ..ops.oracle import N_STATS
from ..ops.sequential import StopMonitor, StopRule
from ..utils import checkpoint as ckpt
from ..utils.config import EngineConfig
from . import mesh as tmesh
from .mesh import PERM_AXIS, ROW_AXIS, Mesh
from .sharded import (
    chunk_shards, gather_corr_net, make_sharded_gatherer,
    pad_square_to_multiple, shard_rows,
)


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
    ``pvalues.tail_counts`` of the materialized null. The adaptive
    streaming loop also sets ``n_perm_used`` (per module) and
    ``finished`` (False after a ``KeyboardInterrupt``)."""

    hi: np.ndarray
    lo: np.ndarray
    eff: np.ndarray
    completed: int
    n_perm_used: np.ndarray | None = None
    finished: bool = True


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
                  config: EngineConfig, dev, mesh: Mesh | None = None
                  ) -> list[dict]:
    """Bucket the modules by capacity and compute each bucket's
    discovery-side properties (exact ``eigh`` summary): the buckets
    :meth:`PermutationEngine.from_parts` takes. Raises on a module with
    fewer than two nodes or module sizes beyond the pool. With
    ``config.network_from_correlation`` the discovery network submatrices
    derive from the gathered correlation and ``disc_net`` is not read. With
    a ``mesh`` (one perm row of a row-sharded engine's) the discovery
    matrices are split by rows over it and gathered by the sum of the row
    blocks' shares, as the JAX package's row-sharded engine does. With
    ``disc_corr`` None (data-only) every submatrix derives from the
    discovery data (:func:`~netrep_tpu_torch.atlas.modules.
    make_disc_props_data_only`)."""
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
    data_only = disc_corr is None
    dc = None if data_only else _as_f32(disc_corr, dev)
    dn = None if net_beta is not None else _as_f32(disc_net, dev)
    dd = None if disc_data is None else _as_f32(disc_data, dev)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    by_cap: dict[int, list[int]] = {}
    for k, m in enumerate(modules):
        by_cap.setdefault(config.rounded_cap(m.size), []).append(k)
    caps = sorted(by_cap)
    didxs = [torch.as_tensor(np.stack(
        [_pad_to(modules[k].disc_idx.astype(np.int64), cap)
         for k in by_cap[cap]]), device=dev) for cap in caps]
    if data_only:
        # the submatrices derive from the transposed data's rows below
        subs = [(None, None)] * len(caps)
    elif mesh is not None:
        # every bucket's submatrices in one gather launch per row block
        R = mesh.shape[ROW_AXIS]
        dc = shard_rows(pad_square_to_multiple(dc, R), mesh)
        dn = None if dn is None else shard_rows(
            pad_square_to_multiple(dn, R), mesh)
        subs = zip(*gather_corr_net(make_sharded_gatherer(mesh), dc, dn,
                                    didxs, net_beta))
    else:
        subs = []
        for didx in didxs:
            sub_c = tstats.gather_submatrix(dc, didx)
            subs.append((sub_c, tstats.derived_net(sub_c, net_beta)
                         if dn is None else tstats.gather_submatrix(dn, didx)))

    buckets = []
    for cap, didx, (sub_c, sub_n) in zip(caps, didxs, subs):
        pos = by_cap[cap]
        mask = np.zeros((len(pos), cap), np.float32)
        for r, k in enumerate(pos):
            mask[r, : modules[k].size] = 1.0
        mask = torch.as_tensor(mask, device=dev)
        disc = (
            make_disc_props_data_only(dd.T, didx, mask, net_beta)
            if data_only else tstats.make_disc_props(
                sub_c, sub_n,
                dd[:, didx].permute(1, 0, 2) if dd is not None else None,
                mask)
        )
        buckets.append(dict(
            cap=cap, module_pos=pos, disc=disc,
            obs_idx=np.stack([_pad_to(modules[k].test_idx, cap)
                              for k in pos]),
            slices=[(int(offsets[k]), modules[k].size) for k in pos],
        ))
    return buckets


@dataclasses.dataclass
class Checkpointer:
    """Where and how often a null loop saves, and the identity its
    checkpoints carry: the key data of the permutation stream and the
    problem's fingerprint (:func:`checkpointer`)."""

    path: str
    every: int
    key_data: np.ndarray
    fingerprint: np.ndarray

    def load(self) -> dict | None:
        return ckpt.load_null_checkpoint(self.path)

    def save(self, nulls, done: int, extra: dict | None = None) -> None:
        ckpt.save_null_checkpoint(self.path, nulls, done, self.key_data,
                                  self.fingerprint, extra=extra)


#: namespace of the streaming loops' checkpoint identity: a streaming
#: checkpoint never resumes a materialized run and the reverse (the JAX
#: package's ``_STREAM_FP``)
_STREAM_FP = b"stream-counts|"


def checkpointer(engine, key: trandom.ThreefryKey, path: str | None,
                 every: int, fingerprint_extra: bytes = b""
                 ) -> Checkpointer | None:
    """The :class:`Checkpointer` of a run at ``path`` (None: no
    checkpoints). Its identity is the JAX package's, byte for byte, for
    the same problem and seed (``netrep_tpu/parallel/engine.py::
    _checkpoint_identity``): the key's words and the engine's fingerprint
    with ``fingerprint_extra`` appended."""
    if path is None:
        return None
    engine.fingerprint_digest()  # raises without a checkpoint identity
    fp = ckpt.engine_fingerprint(engine)
    if fingerprint_extra:
        fp = np.concatenate(
            [fp, np.frombuffer(fingerprint_extra, dtype=np.uint8)])
    return Checkpointer(str(path), int(every), key.data(), fp)


def chunk_counts(stream_parts: Callable, monitor,
                 to_active: Callable) -> Callable:
    """``build() -> counts(keys, valid)`` for
    :func:`run_adaptive_stream_chunks`: ``stream_parts()`` gives the
    ``(count, pull)`` of the current buckets, whose device tallies
    accumulate; a chunk's ``(hi, lo, eff)`` is the difference of two host
    reads (one copy each), ``to_active(delta, positions)`` reshaping each
    to the monitor's ``(n_active, n_cells)``."""

    def build():
        count, pull = stream_parts()
        last = [pull()]

        def counts(keys, valid):
            count(keys, valid)
            now = pull()
            pos = monitor.active_positions()
            out = tuple(to_active(a - b, pos) for a, b in zip(now, last[0]))
            last[0] = now
            return out

        return counts

    return build


def run_checkpointed_chunks(key, n_perm: int, C: int, chunk: Callable,
                            write: Callable, alloc_shape: tuple,
                            progress=None, ck: Checkpointer | None = None,
                            perm_axis: int = 0, full: bool = False
                            ) -> tuple[np.ndarray, int]:
    """The materialized null loop: ``chunk(keys)`` for permutations
    ``[start, start + C)``, ``write(nulls, outs, start, take)`` once they
    land (``outs`` may run past ``take``: with ``full`` every chunk, the
    tail too, draws all ``C`` keys, so that a mesh splits it evenly). Chunk
    k+1 is enqueued before chunk k is copied back, so the device works
    while the host waits on the copy.

    With a :class:`Checkpointer` the loop resumes from its file (exact:
    the keys depend only on the permutation index), saves every
    ``ck.every`` permutations at chunk boundaries and at the end; a
    ``KeyboardInterrupt`` copies back the chunk that was landing and
    returns the partial null (a second one abandons that chunk), and any
    other exception saves what completed before it propagates. Returns
    ``(nulls, completed)``, NaN past ``completed``."""
    nulls, start = None, 0
    if ck is not None:
        loaded = ck.load()
        if loaded is not None:
            nulls, start = ckpt.validate_resume(
                loaded, n_perm, ck.key_data, ck.fingerprint, ck.path,
                perm_axis=perm_axis)
    if nulls is None:
        nulls = np.full(alloc_shape, np.nan)
    dispatched = completed = last_saved = start
    pending = None
    try:
        while dispatched < n_perm or pending is not None:
            nxt = None
            if dispatched < n_perm:
                take = min(C, n_perm - dispatched)
                nxt = (chunk(trandom.perm_keys(key, dispatched,
                                               C if full else take)),
                       dispatched, take)
                dispatched += take
            if pending is not None:
                outs, at, take_p = pending
                write(nulls, outs, at, take_p)
                completed = at + take_p
                if progress is not None:
                    progress(completed, n_perm)
                if ck is not None and completed - last_saved >= ck.every:
                    ck.save(nulls, completed)
                    last_saved = completed
            pending = nxt
    except KeyboardInterrupt:
        # the copy back waits for the chunk's kernels to finish
        if pending is not None:
            try:
                outs, at, take_p = pending
                write(nulls, outs, at, take_p)
                completed = at + take_p
            except KeyboardInterrupt:
                pass
    except BaseException:
        if pending is not None:
            try:
                outs, at, take_p = pending
                write(nulls, outs, at, take_p)
                completed = at + take_p
            except Exception:  # the original error re-raises below
                pass
        if ck is not None and completed > last_saved:
            ck.save(nulls, completed)
        raise
    if ck is not None and completed > last_saved:
        ck.save(nulls, completed)
    return nulls, completed


def run_stream_superchunks(key, n_perm: int, C: int, K: int,
                           count: Callable, pull: Callable, progress=None,
                           ck: Checkpointer | None = None):
    """The streaming null loop: ``count(keys, valid)`` folds chunk tallies
    on the device; ``pull()`` reads them to the host once per superchunk of
    ``K`` chunks. Chunk j of a superchunk starting at ``done`` draws
    ``fold_in(key, done + j*C + i)`` — the permutations the materialized
    loop draws at the same indices — and its tail past ``n_perm`` is gated
    off.

    With a :class:`Checkpointer` the ``(hi, lo, eff)`` tallies are saved
    at superchunk boundaries (``stream_*`` extras beside an empty null, the
    identity in the streaming namespace) and resumed: the device then
    counts from zero and the saved tallies are added on the host. A
    ``KeyboardInterrupt`` returns the tallies of the last whole superchunk
    (tallies and counter commit in one statement). Returns ``((hi, lo,
    eff), completed)``."""
    completed, base = 0, None
    if ck is not None:
        loaded = ck.load()
        if loaded is not None:
            extras = loaded.get("extras") or {}
            if "stream_hi" not in extras:
                raise ValueError(
                    f"checkpoint {ck.path!r} has no streaming "
                    "tallies (it was written by a store_nulls=True run); "
                    "resume it with store_nulls=True or delete it"
                )
            ckpt.validate_identity(loaded, ck.key_data, ck.fingerprint,
                                   ck.path)
            completed = min(int(loaded["completed"]), n_perm)
            base = tuple(np.asarray(extras[f"stream_{f}"], np.int64)
                         for f in ("hi", "lo", "eff"))

    def total():
        now = pull()
        return now if base is None else tuple(b + t
                                              for b, t in zip(base, now))

    def save(counts, done):
        ck.save(np.zeros((0,)), done,
                extra=dict(zip(("stream_hi", "stream_lo", "stream_eff"),
                               counts)))

    counts = total()
    last_saved = completed
    try:
        while completed < n_perm:
            take = min(K * C, n_perm - completed)
            for j in range(K):
                valid = min(C, n_perm - completed - j * C)
                if valid <= 0:
                    break
                count(trandom.perm_keys(key, completed + j * C, C), valid)
            counts, completed = total(), completed + take
            if progress is not None:
                progress(completed, n_perm)
            if ck is not None and completed - last_saved >= ck.every:
                save(counts, completed)
                last_saved = completed
    except KeyboardInterrupt:
        pass
    except BaseException:
        if ck is not None and completed > last_saved:
            save(counts, completed)
        raise
    if ck is not None and completed > last_saved:
        save(counts, completed)
    return counts, completed


def run_adaptive_chunks(key, n_perm: int, C: int, chunk: Callable,
                        write: Callable, alloc_shape: tuple,
                        slice_vals: Callable, monitor, rebucket: Callable,
                        progress=None, ck: Checkpointer | None = None,
                        perm_axis: int = 0, full: bool = False
                        ) -> tuple[np.ndarray, int, bool]:
    """The materialized adaptive (sequential early-stopping) loop: after
    each chunk the :class:`~netrep_tpu_torch.ops.sequential.StopMonitor`
    folds its values (``slice_vals(nulls, done, take, positions)`` views
    them as ``(take, n_active, n_cells)``) and retires decided modules;
    ``rebucket(active)`` then shrinks the engine's buckets, so later
    chunks compute only the active modules. Every chunk still draws
    ``fold_in(key, i)`` over the full pool and a surviving module keeps its
    slice of the draw, so its rows are the fixed run's at the same
    indices; a retired module's later rows stay NaN.

    The loop is synchronous: the monitor must see chunk k before chunk
    k+1's module set is known. Checkpoints carry the monitor's state; on
    resume a chunk written but not yet folded is folded first. Returns
    ``(nulls, completed, finished)``, ``finished`` False only after a
    ``KeyboardInterrupt``."""
    nulls, completed = np.full(alloc_shape, np.nan), 0
    if ck is not None:
        loaded = ck.load()
        if loaded is not None:
            nulls, completed = ckpt.validate_resume(
                loaded, n_perm, ck.key_data, ck.fingerprint, ck.path,
                perm_axis=perm_axis)
            if completed:
                monitor.restore_state(loaded.get("extras") or {})
                gap = completed - monitor.folded
                if gap > 0:
                    monitor.update(slice_vals(nulls, monitor.folded, gap,
                                              monitor.active_positions()),
                                   gap)
    pos = monitor.active_positions()
    if pos.size and pos.size < monitor.n_modules:
        rebucket(pos)
    last_saved = completed
    finished = True
    try:
        while completed < n_perm and monitor.any_active():
            pos = monitor.active_positions()
            take = min(C, n_perm - completed)
            outs = chunk(trandom.perm_keys(key, completed,
                                           C if full else take))
            write(nulls, outs, completed, take)
            completed += take
            newly = monitor.update(
                slice_vals(nulls, completed - take, take, pos), take)
            if progress is not None:
                progress(completed, n_perm)
            if newly.size and monitor.any_active():
                rebucket(monitor.active_positions())
            if ck is not None and completed - last_saved >= ck.every:
                ck.save(nulls, completed, extra=monitor.state_arrays())
                last_saved = completed
    except KeyboardInterrupt:
        finished = False
    except BaseException:
        if ck is not None and completed > last_saved:
            ck.save(nulls, completed, extra=monitor.state_arrays())
        raise
    if ck is not None and completed > last_saved:
        ck.save(nulls, completed, extra=monitor.state_arrays())
    return nulls, completed, finished


def run_adaptive_stream_chunks(key, n_perm: int, C: int,
                               make_counts: Callable, monitor,
                               rebucket: Callable, progress=None,
                               ck: Checkpointer | None = None
                               ) -> tuple[int, bool]:
    """The streaming adaptive loop: one chunk per dispatch, so decisions
    land at the chunk boundaries the materialized adaptive loop takes
    them at, but the dispatch returns each active module's ``(hi, lo,
    eff)`` tallies of the chunk and the monitor folds them
    (:meth:`~netrep_tpu_torch.ops.sequential.StopMonitor.update_counts`).
    The kernel's tallies compare the same float32 values the materialized
    loop widens, so retirement is the same in both modes.

    ``make_counts()`` returns ``counts(keys, valid) -> (hi, lo, eff)``
    over the active modules in ``monitor.active_positions()`` order for
    the current buckets; it is rebuilt after each re-bucketing. Counts and
    monitor commit together, so a checkpoint (the monitor's state in the
    streaming namespace) has no unfolded gap. Returns ``(completed,
    finished)``."""
    completed = 0
    if ck is not None:
        loaded = ck.load()
        if loaded is not None:
            ckpt.validate_identity(loaded, ck.key_data, ck.fingerprint,
                                   ck.path)
            monitor.restore_state(loaded.get("extras") or {})
            completed = min(int(loaded["completed"]), n_perm)

    def save(done):
        ck.save(np.zeros((0,)), done, extra=monitor.state_arrays())

    pos = monitor.active_positions()
    if pos.size and pos.size < monitor.n_modules:
        rebucket(pos)
    counts = make_counts() if monitor.any_active() else None
    last_saved = completed
    finished = True
    try:
        while completed < n_perm and monitor.any_active():
            take = min(C, n_perm - completed)
            hi, lo, eff = counts(trandom.perm_keys(key, completed, C), take)
            newly = monitor.update_counts(hi, lo, take, eff=eff)
            completed = monitor.folded
            if progress is not None:
                progress(completed, n_perm)
            if newly.size and monitor.any_active():
                rebucket(monitor.active_positions())
                counts = make_counts()
            if ck is not None and completed - last_saved >= ck.every:
                save(completed)
                last_saved = completed
    except KeyboardInterrupt:
        finished = False
        completed = monitor.folded
    except BaseException:
        completed = monitor.folded
        if ck is not None and completed > last_saved:
            save(completed)
        raise
    if ck is not None and completed > last_saved:
        save(completed)
    return completed, finished


def root_key(key, device) -> trandom.ThreefryKey:
    """A :class:`~netrep_tpu_torch.random.ThreefryKey` on ``device`` from
    an integer seed or a key."""
    if isinstance(key, trandom.ThreefryKey):
        return key.to(device)
    return trandom.key(int(key), device=device)


def _check_sharding(config: EngineConfig, mesh: Mesh | None) -> bool:
    """Whether the engine row-shards its test matrices; raises the JAX
    package's errors for an unknown ``matrix_sharding`` or ``'row'``
    without a mesh."""
    if config.matrix_sharding not in ("replicated", "row"):
        raise ValueError(
            f"matrix_sharding must be 'replicated' or 'row', got "
            f"{config.matrix_sharding!r}"
        )
    if config.matrix_sharding == "row" and mesh is None:
        raise ValueError("matrix_sharding='row' requires a mesh")
    return mesh is not None and config.matrix_sharding == "row"


def check_data_only(config: EngineConfig, has_data: bool) -> None:
    """The JAX engine's guards of the data-only mode (no correlation, no
    network: every submatrix derives from data), with its texts."""
    if config.network_from_correlation is None:
        raise ValueError(
            "data-only engines (correlation=None, network=None) need the "
            "derivation spec: set EngineConfig.network_from_correlation to "
            "the soft-threshold β (or (β, kind))"
        )
    if not has_data:
        raise ValueError(
            "data-only engines need discovery AND test data matrices — with "
            "no matrices and no data there is nothing to test"
        )
    if config.matrix_sharding == "row":
        raise ValueError(
            "matrix_sharding='row' shards the n×n matrices the data-only "
            "mode exists to never materialize; use 'replicated' (the data "
            "matrix is O(n·samples))"
        )
    if config.gather_mode == "fused":
        raise ValueError(
            "gather_mode='fused' DMAs stored matrix rows; the data-only mode "
            "derives submatrices from data columns — use gather_mode='auto'"
        )
    if config.stat_mode == "fused":
        raise ValueError(
            "stat_mode='fused' is not yet taught the data-only derivation; "
            "use stat_mode='auto' (resolves to the XLA composition here)"
        )


def build_discovery(disc_corr, disc_net, disc_data, modules, pool,
                    config: EngineConfig, dev, mesh: Mesh | None = None
                    ) -> list[dict]:
    """The discovery half of an engine build: the buckets of
    :func:`build_buckets`, after the checks that come first (data-only,
    :func:`check_data_only`; the ``matrix_sharding`` knob against
    ``mesh``; with ``config.network_from_correlation`` the discovery
    network against the construction). On a row-sharded mesh the
    discovery matrices are gathered through perm shard 0's row blocks.
    Once every pair's buckets exist, no discovery matrix is read again
    (``from_parts`` takes them)."""
    data_only = disc_corr is None and disc_net is None
    if data_only:
        check_data_only(config, disc_data is not None)
    row = _check_sharding(config, mesh)
    net_beta = config.network_from_correlation
    if net_beta is not None and not data_only:
        check_derived_network(disc_corr, disc_net, net_beta, "discovery")
    return build_buckets(disc_corr, disc_net, disc_data, modules,
                         np.asarray(pool, dtype=np.int32), config, dev,
                         mesh=mesh.perm_row(0) if row else None)


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
    config : engine knobs (``stat_mode``, ``network_from_correlation`` and
        ``matrix_sharding`` choose the null's path).
    device : where the engine's operands live and its kernels run; None
        means ``"cuda"`` (raises without a card). With a mesh it names the
        mesh's device type, and the operands go to the mesh's devices.
    mesh : optional :class:`~netrep_tpu_torch.parallel.mesh.Mesh`;
        permutation chunks split over the ``perm`` axis (and, on the
        ring path, over the row axis too).

    Inputs may be numpy arrays or tensors; they are copied to the device as
    float32 (a float32 tensor already there is used as it is). With
    ``config.network_from_correlation`` both networks are checked against
    the construction (:func:`check_derived_network`) and only the
    correlations are kept.

    Data-only mode (the atlas module plane): with all four matrices None
    the engine stores no ``n × n`` matrix at all. Every submatrix, observed
    and null, derives from gathered data rows — correlation ``zᵀz/(s-1)``,
    network by ``config.network_from_correlation``
    (:mod:`netrep_tpu_torch.atlas.modules`) — through the composed
    statistics; the device holds ``O(n·s)``. Every null loop runs it
    unchanged. Its guards are the JAX engine's (:func:`check_data_only`).
    """

    def __init__(self, disc_corr, disc_net, disc_data, test_corr, test_net,
                 test_data, modules: Sequence[ModuleSpec], pool,
                 config: EngineConfig = EngineConfig(), device=None,
                 mesh: Mesh | None = None):
        dev = tmesh.resolve_device(mesh, device)
        modules = list(modules)
        has_data = disc_data is not None and test_data is not None
        net_beta = config.network_from_correlation
        data_only = all(m is None for m in (disc_corr, disc_net, test_corr,
                                            test_net))
        pool = np.asarray(pool, dtype=np.int32)
        buckets = build_discovery(disc_corr, disc_net,
                                  disc_data if has_data else None, modules,
                                  pool, config, dev, mesh)
        if net_beta is not None and not data_only:
            check_derived_network(test_corr, test_net, net_beta, "test")
        # the test data is kept TRANSPOSED, (n, n_samples): a module's data
        # slice is then a gather of contiguous rows
        self._setup(
            None if data_only else _as_f32(test_corr, dev),
            None if net_beta is not None else _as_f32(test_net, dev),
            _as_f32(test_data, dev).T if has_data else None,
            pool, buckets, len(modules), config, dev, mesh,
        )
        self.modules = modules
        # the checkpoint identity digests the inputs as given, as the JAX
        # engine does, so the two packages fingerprint a problem alike
        self._digest = ckpt.content_digest(
            [disc_corr, disc_net, disc_data, test_corr, test_net, test_data])

    @classmethod
    def from_parts(cls, test_corr, test_net, test_dataT, pool, buckets,
                   n_modules: int, config: EngineConfig = EngineConfig(),
                   device=None, mesh: Mesh | None = None,
                   modules: Sequence[ModuleSpec] | None = None,
                   digest: str | None = None) -> "PermutationEngine":
        """An engine from its device operands directly (see
        :mod:`netrep_tpu_torch.state`): ``buckets`` is a list of dicts with
        ``cap``, ``module_pos``, ``disc`` (:class:`DiscProps`), ``obs_idx``
        ``(K, cap)`` and ``slices``. ``test_net`` is not read when
        ``config.network_from_correlation`` is set; ``test_corr`` None
        (with ``test_net`` None) builds the data-only mode. ``modules`` and
        ``digest`` (:func:`~netrep_tpu_torch.utils.checkpoint.content_digest`
        of the six original inputs) make the problem's checkpoint
        identity; without them the engine takes no checkpoint."""
        self = cls.__new__(cls)
        dev = tmesh.resolve_device(mesh, device)

        def f32(a):
            return _as_f32(a, dev)

        derived = config.network_from_correlation is not None
        self._setup(
            None if test_corr is None else f32(test_corr),
            None if derived or test_net is None else f32(test_net),
            None if test_dataT is None else f32(test_dataT),
            np.asarray(pool, dtype=np.int32),
            [dict(b, disc=tstats.DiscProps(*(f32(a) for a in b["disc"])))
             for b in buckets],
            n_modules, config, dev, mesh,
        )
        self.modules = None if modules is None else list(modules)
        self._digest = digest
        return self

    def _setup(self, tc, tn, tdT, pool, buckets, n_modules, config, dev,
               mesh=None):
        self.config = config
        self.device = dev
        self.net_beta = config.network_from_correlation
        if tn is None and self.net_beta is None:
            raise ValueError(
                "test_net is None but network_from_correlation is not set"
            )
        #: no stored test matrix: every submatrix derives from the data
        self.data_only = tc is None
        if self.data_only:
            check_data_only(config, tdT is not None)
        self.stat_mode = ("xla" if self.data_only
                          else config.resolved_stat_mode())
        self.n_modules = int(n_modules)
        self.mesh = mesh
        self.row_sharded = _check_sharding(config, mesh)
        #: row-sharded test matrices, ``blocks[p][r]`` (None: replicated)
        self._rows_c = self._rows_n = self._gather_rep = None
        if self.row_sharded:
            # only the row blocks are kept: on a one-device mesh they are
            # views of the (padded) matrix, never a second copy beside it
            R = mesh.shape[ROW_AXIS]
            self._rows_c = shard_rows(pad_square_to_multiple(tc, R), mesh)
            if tn is not None:
                self._rows_n = shard_rows(pad_square_to_multiple(tn, R), mesh)
            self._gather_rep = make_sharded_gatherer(mesh)
            tc = tn = None
        self._test_corr = None if tc is None else tc.contiguous()
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
        #: every module's bucket; ``buckets`` is the active subset
        #: (:meth:`rebucket`)
        self._buckets_full = list(self.buckets)
        self._shards = None

    # ------------------------------------------------------------------
    # Mesh
    # ------------------------------------------------------------------

    def _stat_fused_ring(self) -> bool:
        """Whether null chunks take the ring path: the chunk splits over
        BOTH mesh axes and each shard assembles its submatrices by
        streaming the row blocks around its ring."""
        return self.stat_mode == "fused" and self.row_sharded

    def effective_chunk(self) -> int:
        """Chunk size, rounded to a multiple of the mesh's permutation axis
        — or of the whole mesh (perm × row) on the ring path, where the row
        axis carries its own permutation shard."""
        C = self.config.chunk_size
        if self.mesh is not None:
            ax = self.mesh.shape[PERM_AXIS]
            if self._stat_fused_ring():
                ax *= self.mesh.shape[ROW_AXIS]
            C = max(ax, (C // ax) * ax)
        return C

    def _on(self, p: int, r: int, placed: dict) -> "PermutationEngine":
        """A mesh-free view of this engine for the shard at ``(p, r)``: the
        pool, discovery properties, test data and (replicated) test
        matrices on its device — the tensors themselves where they are
        already there, one copy per device otherwise (``placed`` keeps
        them) — and, row-sharded, perm shard p's row blocks with their
        gatherer."""
        dev = self.mesh.devices[p, r]
        rep = copy.copy(self)
        rep.mesh, rep.device, rep._shards = None, dev, None

        def mv(a):
            if a is None:
                return None
            if (id(a), dev) not in placed:
                placed[(id(a), dev)] = a.to(dev)
            return placed[(id(a), dev)]

        rep._test_corr, rep._test_net = mv(self._test_corr), mv(self._test_net)
        rep._test_dataT, rep._pool_dev = mv(self._test_dataT), mv(self._pool_dev)
        rep.buckets = [
            dataclasses.replace(b, disc=tstats.DiscProps(*map(mv, b.disc)),
                                obs_idx=mv(b.obs_idx), take=mv(b.take))
            for b in self.buckets
        ]
        if self.row_sharded:
            rep._rows_c = self._rows_c[p: p + 1]
            rep._rows_n = (None if self._rows_n is None
                           else self._rows_n[p: p + 1])
            rep._gather_rep = make_sharded_gatherer(self.mesh.perm_row(p))
        return rep

    def _shard_plan(self) -> list:
        """``(p, r, slice, engine view)`` per shard, in chunk order
        (:func:`~netrep_tpu_torch.parallel.sharded.chunk_shards`)."""
        if self._shards is None:
            placed: dict = {}
            self._shards = [
                (p, r, sl, self._on(p, r, placed))
                for p, r, sl in chunk_shards(
                    self.mesh, self.effective_chunk(),
                    self._stat_fused_ring())
            ]
        return self._shards

    def _ring_values(self, keys: trandom.ThreefryKey) -> list:
        """The ring chunk body: each shard draws its slice of ``keys`` and
        builds its index blocks; each perm row's shards assemble their
        submatrices by :func:`ring_gather_all`; each shard then computes
        the composed statistics of its slice. Per shard, per-bucket ``(C /
        (P·R), K, 7)`` on its device."""
        plan = self._shard_plan()
        R = self.mesh.shape[ROW_AXIS]
        rows_per = self._rows_c[0][0].shape[0]
        out = []
        for p0 in range(0, len(plan), R):
            ring = plan[p0: p0 + R]
            p = ring[0][0]
            idx = []
            for _p, _r, sl, eng in ring:
                perm = trandom.permutation(
                    trandom.ThreefryKey(keys.words[sl]).to(eng.device),
                    eng._pool_dev)
                idx.append([eng._bucket_idx(perm, b) for b in eng.buckets])
            mats = [self._rows_c[p]] + (
                [] if self._rows_n is None else [self._rows_n[p]])
            subs = ring_gather_all(mats, idx, rows_per,
                                   devices=list(self.mesh.devices[p]))
            for j, (_p, _r, _sl, eng) in enumerate(ring):
                sub_n = subs[j][1] if len(mats) > 1 else [None] * len(idx[j])
                out.append([
                    eng._stats(b, ix, sc, sn) for b, ix, sc, sn in zip(
                        eng.buckets, idx[j], subs[j][0], sub_n)
                ])
            del subs
        return out

    def _shard_values(self, keys: trandom.ThreefryKey) -> list:
        """Per shard, per-bucket null statistics of its slice of ``keys``,
        on its device: the ring path, or each perm shard's own body."""
        if self._stat_fused_ring():
            return self._ring_values(keys)
        return [
            eng._values(trandom.permutation(
                trandom.ThreefryKey(keys.words[sl]).to(eng.device),
                eng._pool_dev))
            for _p, _r, sl, eng in self._shard_plan()
        ]

    # ------------------------------------------------------------------
    # Observed statistics
    # ------------------------------------------------------------------

    def observed(self) -> np.ndarray:
        """(n_modules, 7) observed statistics on the actual overlap sets,
        with the exact ``eigh`` summary (row-sharded: gathered from the
        row blocks, every bucket at once)."""
        out = np.full((self.n_modules, N_STATS), np.nan)
        subs = (zip(*self._gather([b.obs_idx for b in self.buckets]))
                if self.row_sharded else None)
        for b in self.buckets:
            if self.data_only:
                res = data_only_gather_and_stats(
                    b.disc, b.obs_idx, self._test_dataT, self.net_beta,
                    n_iter=self.config.power_iters, summary_method="eigh")
            elif self.row_sharded:
                res = self._stats(b, b.obs_idx, *next(subs),
                                  summary_method="eigh")
            else:
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

    def _gather(self, idx_list: list) -> tuple[list, list]:
        """The test correlation and network submatrices of every index
        tensor of ``idx_list`` (one per bucket), each matrix in one gather
        launch — on row-sharded matrices one per row block, each writing
        the rows it owns. In derived-network mode the network list holds
        None (:meth:`_stats` derives each network from its correlation)."""
        if self.row_sharded:
            if self._rows_n is None:
                sub_c = self._gather_rep(self._rows_c, None, idx_list)
                return sub_c, [None] * len(idx_list)
            return self._gather_rep(self._rows_c, self._rows_n, idx_list)
        sub_c = gather_submatrix_fused_many(self._test_corr, idx_list)
        sub_n = ([None] * len(idx_list) if self._test_net is None
                 else gather_submatrix_fused_many(self._test_net, idx_list))
        return sub_c, sub_n

    def _stats(self, b: _Bucket, idx: torch.Tensor, sub_c, sub_n,
               summary_method: str | None = None) -> torch.Tensor:
        """The composed statistics of one bucket from its gathered
        submatrices (``sub_n`` None: derived from ``sub_c``): the
        standardized data slice, then ``module_stats_masked`` batched over
        (C, K) by broadcasting against the bucket's ``(K, …)`` discovery
        properties."""
        if sub_n is None:
            sub_n = tstats.derived_net(sub_c, self.net_beta)
        zd = (
            tstats.gather_zdata(self._test_dataT, idx, b.disc.mask)
            if self.has_data else None
        )
        return tstats.module_stats_masked(
            b.disc, sub_c, sub_n, zd, n_iter=self.config.power_iters,
            summary_method=summary_method or self.config.summary_method,
        )

    def _values(self, perm: torch.Tensor) -> list[torch.Tensor]:
        """Per-bucket ``(C, K, 7)`` null statistics of the drawn
        permutations ``perm`` ``(C, P)``: one fused-statistics launch per
        bucket, or the composed statistics — every bucket's submatrices
        gathered at once (one launch per matrix), then :meth:`_stats`
        bucket by bucket, each bucket's submatrices freed once used. In
        data-only mode each bucket's submatrices derive from its gathered
        data rows instead, and no kernel runs."""
        idxs = [self._bucket_idx(perm, b) for b in self.buckets]
        if self.data_only:
            return [data_only_gather_and_stats(
                b.disc, idx, self._test_dataT, self.net_beta,
                n_iter=self.config.power_iters,
                summary_method=self.config.summary_method,
            ) for b, idx in zip(self.buckets, idxs)]
        if self.stat_mode == "fused":
            return [fused_stats_values(
                self._test_corr, self._test_net, self._test_dataT, b.disc,
                idx, net_beta=self.net_beta, n_iter=self.config.power_iters,
            ) for b, idx in zip(self.buckets, idxs)]
        subs_c, subs_n = self._gather(idxs)
        outs = []
        for i, (b, idx) in enumerate(zip(self.buckets, idxs)):
            outs.append(self._stats(b, idx, subs_c[i], subs_n[i]))
            subs_c[i] = subs_n[i] = None
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
        _add_tallies(tallies, deltas)

    def _chunk(self, keys: trandom.ThreefryKey) -> list[torch.Tensor]:
        if self.mesh is None:
            return self._values(trandom.permutation(keys, self._pool_dev))
        shards = self._shard_values(keys)
        return [torch.cat([s[i].to(self.device) for s in shards])
                for i in range(len(self.buckets))]

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
        """Device tallies → ``(n_modules, 7)`` int64 host arrays, every
        bucket's in one copy."""
        return tuple(pull_tallies([(self.buckets, tallies)],
                                  self.n_modules)[0])

    def _stream_parts(self, observed):
        """``(count(keys, valid), pull())`` of the streaming null. On a
        mesh each shard keeps its own tallies on its device, gated by the
        validity mask offset by its slice's first column; ``pull`` sums
        them on the host."""
        if self.mesh is None:
            obs = self._obs_buckets(observed)
            tallies = self._zero_tallies()

            def count(keys, valid):
                self._count(trandom.permutation(keys, self._pool_dev), valid,
                            obs, tallies)

            return count, lambda: self._pull(tallies)

        plan = self._shard_plan()
        obs = [eng._obs_buckets(observed) for *_, eng in plan]
        tallies = [eng._zero_tallies() for *_, eng in plan]
        ring = self._stat_fused_ring()

        def count(keys, valid):
            vals = self._ring_values(keys) if ring else None
            for s, (_p, _r, sl, eng) in enumerate(plan):
                own = max(0, min(sl.stop, valid) - sl.start)
                if ring:
                    keep = torch.arange(sl.stop - sl.start,
                                        device=eng.device) < own
                    _add_tallies(tallies[s], count_buckets(vals[s], obs[s],
                                                           keep))
                else:
                    eng._count(trandom.permutation(
                        trandom.ThreefryKey(keys.words[sl]).to(eng.device),
                        eng._pool_dev), own, obs[s], tallies[s])

        def pull():
            parts = [eng._pull(t) for (*_, eng), t in zip(plan, tallies)]
            return tuple(sum(x) for x in zip(*parts))

        return count, pull

    # ------------------------------------------------------------------
    # Null runs: fixed, checkpointed, adaptive
    # ------------------------------------------------------------------

    def fingerprint_digest(self) -> str:
        """Content digest of the six original inputs (the JAX engine's
        ``fingerprint_digest``), part of the checkpoint identity."""
        if self._digest is None or self.modules is None:
            raise ValueError(
                "this engine was built from parts without modules= and "
                "digest=, so it has no checkpoint identity; pass both to "
                "from_parts or build it from the inputs"
            )
        return self._digest

    def rebucket(self, active) -> None:
        """Restrict the buckets to the modules at the global positions
        ``active`` — the adaptive loops' retirement: later chunks compute
        only those modules. Each survivor keeps its original slice of the
        drawn permutation (and the ``take`` positions built from it), and
        permutations are still drawn over the full pool, so its index sets
        are the fixed run's. Discovery properties, observed indices and
        ``take`` are row-filtered on the device; a mesh's shard views are
        rebuilt from the new buckets. ``rebucket(range(n_modules))``
        restores the full set."""
        keep = {int(a) for a in np.asarray(active, dtype=np.int64).ravel()}
        bad = keep - set(range(self.n_modules))
        if bad:
            raise ValueError(f"unknown module positions: {sorted(bad)}")
        if keep == set(range(self.n_modules)) and sum(
                len(b.module_pos) for b in self.buckets) == self.n_modules:
            return
        new = []
        for b in self._buckets_full:
            sel = [i for i, p in enumerate(b.module_pos) if p in keep]
            if not sel:
                continue
            if len(sel) == len(b.module_pos):
                new.append(b)
                continue
            ix = torch.as_tensor(sel, device=b.obs_idx.device)
            new.append(_Bucket(
                cap=b.cap, module_pos=[b.module_pos[i] for i in sel],
                disc=tstats.DiscProps(*(a.index_select(0, ix)
                                        for a in b.disc)),
                obs_idx=b.obs_idx.index_select(0, ix),
                slices=[b.slices[i] for i in sel],
                take=b.take.index_select(0, ix),
            ))
        if not new:
            raise ValueError("rebucket needs at least one active module")
        self.buckets = new
        self._shards = None

    def _null_write(self) -> Callable:
        """Chunk → null scatter of the fixed and adaptive loops; reads
        ``self.buckets`` at call time, so after :meth:`rebucket` it writes
        exactly the surviving modules."""

        def write(nulls, outs, at, take):
            for b, o in zip(self.buckets, outs):
                nulls[at: at + take, b.module_pos] = (
                    o[:take].cpu().numpy().astype(np.float64)
                )

        return write

    def run_null(self, n_perm: int, key=0,
                 progress: Callable[[int, int], None] | None = None,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 8192,
                 ) -> tuple[np.ndarray, int]:
        """The materialized permutation null: ``(nulls, completed)`` with
        ``nulls`` ``(n_perm, n_modules, 7)`` float64. ``key`` is an integer
        seed or a :class:`~netrep_tpu_torch.random.ThreefryKey`; the same
        key gives the same null regardless of chunk size and mesh.
        ``progress(done, total)`` is called after each chunk lands on the
        host.

        ``checkpoint_path``: the partial null is saved there every
        ``checkpoint_every`` permutations (at chunk boundaries), on an
        interrupt or error and at the end, and an existing checkpoint of
        the same problem and key is resumed — exactly, and across mesh
        shapes and packages (:func:`run_checkpointed_chunks`). A
        ``KeyboardInterrupt`` returns the partial null with ``completed <
        n_perm``."""
        key = root_key(key, self.device)
        return run_checkpointed_chunks(
            key, n_perm, self.effective_chunk(), self._chunk,
            self._null_write(), (n_perm, self.n_modules, N_STATS),
            progress, checkpointer(self, key, checkpoint_path,
                                   checkpoint_every),
            full=self.mesh is not None,
        )

    def run_null_streaming(self, n_perm: int, observed: np.ndarray, key=0,
                           progress: Callable[[int, int], None] | None = None,
                           checkpoint_path: str | None = None,
                           checkpoint_every: int = 8192,
                           ) -> StreamCounts:
        """The streaming permutation null: exceedance tallies against
        ``observed`` ``(n_modules, 7)``, accumulated on the device in int32
        over ``config.superchunk`` chunks between host reads. For the same
        key the tallies equal ``tail_counts`` of :meth:`run_null`'s
        null. Checkpoints as :meth:`run_null`, saved at superchunk
        boundaries (:func:`run_stream_superchunks`); a materialized
        checkpoint is refused."""
        key = root_key(key, self.device)
        count, pull = self._stream_parts(observed)
        (hi, lo, eff), completed = run_stream_superchunks(
            key, n_perm, self.effective_chunk(),
            self.config.resolved_superchunk, count, pull, progress,
            checkpointer(self, key, checkpoint_path, checkpoint_every,
                         _STREAM_FP),
        )
        return StreamCounts(hi=hi, lo=lo, eff=eff, completed=completed)

    def _monitor(self, observed, alternative, rule) -> StopMonitor:
        return StopMonitor(
            np.asarray(observed, dtype=np.float64).reshape(
                self.n_modules, -1),
            alternative, rule or StopRule(),
        )

    def run_null_adaptive(self, n_perm: int, observed: np.ndarray, key=0,
                          alternative: str = "greater", rule=None,
                          progress: Callable[[int, int], None] | None = None,
                          checkpoint_path: str | None = None,
                          checkpoint_every: int = 8192, priors=None,
                          ) -> tuple[np.ndarray, int, bool]:
        """Sequential early-stopping variant of :meth:`run_null`:
        ``n_perm`` becomes a ceiling, and a module whose decision at the
        stop rule's alpha is settled retires and drops out of later chunks,
        its remaining rows left NaN (per-module counts:
        :func:`~netrep_tpu_torch.ops.pvalues.effective_nperm`).
        ``observed`` are the engine's observed statistics and
        ``alternative`` the tail the p-values will use; ``priors`` an
        optional ``(hi, lo, n_used)`` triple seeded into the monitor's
        decisions (:meth:`~netrep_tpu_torch.ops.sequential.StopMonitor.
        seed_priors`). Returns ``(nulls, completed, finished)``:
        ``completed`` is the deepest module's count, ``finished`` False
        only after a ``KeyboardInterrupt``."""
        monitor = self._monitor(observed, alternative, rule)
        if priors is not None:
            monitor.seed_priors(*priors)
        return self.run_null_monitored(
            n_perm, key, monitor, progress=progress,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every)

    def run_null_monitored(self, n_perm: int, key, monitor,
                           progress: Callable[[int, int], None] | None = None,
                           checkpoint_path: str | None = None,
                           checkpoint_every: int = 8192,
                           ) -> tuple[np.ndarray, int, bool]:
        """The materialized null under a caller's retirement monitor (the
        :class:`~netrep_tpu_torch.ops.sequential.StopMonitor` surface):
        after each chunk it folds the active modules' values and names the
        modules to retire, which :meth:`rebucket` drops from later chunks
        (:func:`run_adaptive_chunks`). The engine is left at full strength
        on exit."""
        key = root_key(key, self.device)

        def slice_vals(nulls, done, take, pos):
            return nulls[done: done + take][:, pos, :]

        try:
            return run_adaptive_chunks(
                key, n_perm, self.effective_chunk(), self._chunk,
                self._null_write(), (n_perm, self.n_modules, N_STATS),
                slice_vals, monitor, self.rebucket, progress,
                checkpointer(self, key, checkpoint_path, checkpoint_every),
                full=self.mesh is not None,
            )
        finally:
            self.rebucket(range(self.n_modules))

    def run_null_adaptive_streaming(
            self, n_perm: int, observed: np.ndarray, key=0,
            alternative: str = "greater", rule=None,
            progress: Callable[[int, int], None] | None = None,
            checkpoint_path: str | None = None, checkpoint_every: int = 8192,
    ) -> StreamCounts:
        """Streaming variant of :meth:`run_null_adaptive`: one chunk per
        dispatch, the monitor folding the kernel's tallies
        (:func:`run_adaptive_stream_chunks`), so retirement equals the
        materialized adaptive run's at the same key. Returns a
        :class:`StreamCounts` with per-module ``n_perm_used`` and the
        ``finished`` flag."""
        monitor = self._monitor(observed, alternative, rule)
        key = root_key(key, self.device)
        try:
            completed, finished = run_adaptive_stream_chunks(
                key, n_perm, self.effective_chunk(),
                chunk_counts(lambda: self._stream_parts(observed), monitor,
                             lambda a, pos: a[pos]), monitor,
                self.rebucket, progress,
                checkpointer(self, key, checkpoint_path, checkpoint_every,
                             _STREAM_FP),
            )
        finally:
            self.rebucket(range(self.n_modules))
        eff = monitor.eff if monitor.eff is not None else np.zeros_like(
            monitor.hi)
        return StreamCounts(
            hi=monitor.hi.copy(), lo=monitor.lo.copy(), eff=eff.copy(),
            completed=completed, n_perm_used=monitor.n_used.copy(),
            finished=finished,
        )


def pull_tallies(parts, n_modules: int) -> list[np.ndarray]:
    """``(3, n_modules, 7)`` int64 host tallies ``(hi, lo, eff)`` of each
    ``(buckets, tallies)`` part (tensors on one device): every bucket's
    brought to the host in one copy."""
    flat = torch.cat([t.reshape(-1) for _b, tallies in parts
                      for acc in tallies for t in acc]).cpu().numpy()
    out, at = [], 0
    for buckets, _t in parts:
        o = np.zeros((3, n_modules, N_STATS), np.int64)
        for b in buckets:
            n = len(b.module_pos) * N_STATS
            for f in range(3):
                o[f, b.module_pos] = flat[at: at + n].reshape(-1, N_STATS)
                at += n
        out.append(o)
    return out


def _add_tallies(tallies, deltas) -> None:
    """Fold per-bucket ``(hi, lo, eff)`` deltas into ``tallies`` in
    place."""
    for acc, d in zip(tallies, deltas):
        for t, x in zip(acc, d):
            t += x
