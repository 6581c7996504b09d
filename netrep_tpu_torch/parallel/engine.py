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

Storage (``config.dtype``): the test correlation, network and transposed
data the engine holds are float32 or bfloat16, narrowed from the float32
inputs (so a float64 input rounds through float32, as in the JAX package);
the discovery side stays float32. Every kernel takes either type and
widens on load; the composed statistics widen right after the gather (a
derived network too is computed from the widened correlation).

The screened null (``config.null_precision='bf16_rescue'``,
:mod:`~netrep_tpu_torch.parallel.screened`) runs every loop above on the
composed statistics of bf16-rounded gathered blocks and rescues the
ambiguous permutations through the float32 chunk, so its counts and
p-values equal the float32 run's.

Every loop takes the fault ladder (``fault_policy``,
:mod:`netrep_tpu_torch.utils.faults`), the event bus (``telemetry``,
:mod:`netrep_tpu_torch.utils.telemetry`) and the dispatch accounting
(``profile``); with all three off a loop runs as it did without them and
pays one ``None`` check per run. The multi-test engine
(:mod:`netrep_tpu_torch.parallel.multitest`) composes T of these engines'
shard plans over the same mesh.

A mesh whose ``perm`` axis spans processes
(:mod:`netrep_tpu_torch.parallel.distributed`) runs in each process only
the shards it drives: the materialized null is allgathered in chunk order
(:func:`~netrep_tpu_torch.parallel.distributed.gather_to_host`), the
streaming tallies are summed across processes in int64, and the adaptive
loops fold the same gathered values everywhere, so every process returns
the whole result and retires the same modules. Process 0 alone writes the
checkpoint; every process resumes from what it read.

A pack of requests (:mod:`netrep_tpu_torch.serve.packer`) is this engine
over the union of their modules through four hooks: where each module
slices the draw (:meth:`PermutationEngine._slice_offsets`), its ``take``
positions (``_take_positions``), the draw of a chunk's keys (``_draw``)
and the run's root key (``_root_key``). ``observed_cache=``
(:class:`ObservedCache`) shares discovery props and observed statistics
between engines, as the all-pairs grid does.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import threading
import time
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from .. import random as trandom
from ..atlas.modules import (
    data_only_gather_and_stats, make_disc_props_data_only,
)
from ..models import dataset as ds
from ..ops import stats as tstats
from ..ops.fused_gather import gather_submatrix_fused_many
from ..ops.fused_stats import (
    fused_stats_counts, fused_stats_values, ring_gather_all,
)
from ..ops.oracle import N_STATS
from ..ops.sequential import StopMonitor, StopRule
from ..utils import checkpoint as ckpt
from ..utils import aot, autotune, costmodel
from ..utils import faults as flt
from ..utils import perfledger
from ..utils import telemetry as tm
from ..utils.config import EngineConfig
from ..utils.profiling import NullProfile, make_memory_probe
from . import distributed
from . import mesh as tmesh
from . import screened as scr
from .mesh import PERM_AXIS, ROW_AXIS, Mesh
from .sharded import (
    chunk_shards, make_sharded_gatherer,
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


def _as_stored(a, device, dtype) -> torch.Tensor:
    """A test operand for the engine: a tensor already of the storage type
    ``dtype`` on ``device`` as it is (the serving tier's shared copy,
    :func:`~netrep_tpu_torch.serve.pool.device_copy`), else
    :func:`_as_f32` (the engine narrows it to ``dtype``)."""
    if isinstance(a, torch.Tensor) and a.dtype == dtype:
        return a.to(device)
    return _as_f32(a, device)


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
        # netrep: allow(rng-discipline) — fixed-seed sample positions of the derived-network input check (the JAX package's); never touches null results
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


def _block_positions(cap: int, slices, n_pool: int, device,
                     bases=None) -> torch.Tensor:
    """``(K, cap)`` positions into ``perm`` padded with one zero column:
    module k reads ``[off, off + size)``, its padded slots read the zero
    column ``n_pool``. ``bases`` (one per module) shift each module's
    positions: a pack's draw is one permutation per request laid end to
    end, and module k reads its request's (``bases[k] = g·P``)."""
    pos = np.full((len(slices), cap), n_pool, dtype=np.int64)
    for k, (off, size) in enumerate(slices):
        at = off if bases is None else bases[k] + off
        pos[k, :size] = np.arange(at, at + size)
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


def _idx_blocks_grouped(perms: torch.Tensor, cap: int, slices,
                       groups) -> torch.Tensor:
    """Grouped variant of :func:`_idx_blocks` for packed chunks: ``perms``
    is ``(..., G, P)``, one drawn permutation per key group (a packed
    request), and module k slices ``[off, off + size)`` out of its group's
    permutation ``groups[k]`` — the JAX package's ``_idx_blocks_grouped``.
    Offsets are request-local, so slices of different groups may overlap.
    Result ``(..., K, cap)``, padded slots read node 0 (masked
    downstream)."""
    G, P = perms.shape[-2:]
    take = _block_positions(cap, slices, G * P, perms.device,
                            [int(g) * P for g in groups])
    return _take_blocks(perms.flatten(-2), take)


def props_mode(data_only: bool, row_sharded: bool, net_beta,
               has_data: bool) -> str:
    """The :class:`ObservedCache` mode bits of a discovery side: what,
    beyond its content and the module indices, changes the props it
    gives (the JAX engine's ``_props_mode``)."""
    return (f"{'data_only' if data_only else 'dense'}|"
            f"row:{int(row_sharded)}|beta:{net_beta!r}|"
            f"data:{int(has_data)}")


class ObservedCache:
    """Digest-keyed dedup cache of the all-pairs grid (the JAX package's
    ``ObservedCache``).

    Two maps, both content-addressed so a stale hit is impossible:

    - **discovery props** — a bucket's :class:`~netrep_tpu_torch.ops.
      stats.DiscProps` on the device, keyed by the discovery side's content
      digest, the mode bits (:func:`props_mode`), the capacity and the
      bucket's padded index and mask bytes: every cell of one grid row
      computes its buckets once and later engines share the tensors;
    - **observed statistics** — the ``(n_modules, 7)`` observed array,
      keyed by the engine's fingerprint digest and its module specs: an
      engine rebuilt for the same cell skips the observed pass.

    A hit emits ``grid_dedup_hit`` on the ambient telemetry bus with the
    map's kind; :meth:`stats` gives the hit and miss counters. Thread-safe.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._props: dict = {}
        self._obs: dict = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _digest(*arrays) -> str:
        h = hashlib.blake2b(digest_size=8)
        for a in arrays:
            a = np.ascontiguousarray(a)
            h.update(str(a.shape).encode() + str(a.dtype).encode())
            h.update(a.tobytes())
        return h.hexdigest()

    def props_key(self, disc_digest: str, mode: str, cap: int,
                  didx: np.ndarray, mask: np.ndarray) -> tuple:
        return ("props", disc_digest, mode, int(cap),
                self._digest(didx, mask))

    def observed_key(self, fingerprint: str, spec_sig: str,
                     mode: str) -> tuple:
        return ("observed", fingerprint, spec_sig, mode)

    def _note(self, hit: bool, kind: str) -> None:
        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1
        if hit:
            tel = tm.current()
            if tel is not None:
                tel.emit("grid_dedup_hit", kind=kind)

    def get_props(self, key: tuple):
        with self._lock:
            v = self._props.get(key)
        self._note(v is not None, "props")
        return v

    def put_props(self, key: tuple, props) -> None:
        with self._lock:
            self._props[key] = props

    def get_observed(self, key: tuple) -> np.ndarray | None:
        with self._lock:
            v = self._obs.get(key)
        self._note(v is not None, "observed")
        return None if v is None else v.copy()

    def put_observed(self, key: tuple, observed: np.ndarray) -> None:
        with self._lock:
            self._obs[key] = np.asarray(observed, dtype=np.float64).copy()

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": int(self.hits), "misses": int(self.misses),
                "props_entries": len(self._props),
                "observed_entries": len(self._obs),
            }


def build_buckets(disc_corr, disc_net, disc_data, modules, pool,
                  config: EngineConfig, dev, mesh: Mesh | None = None,
                  offsets=None, cache=None) -> list[dict]:
    """Bucket the modules by capacity and compute each bucket's
    discovery-side properties (exact ``eigh`` summary): the buckets
    :meth:`PermutationEngine.from_parts` takes. Raises on a module with
    fewer than two nodes or module sizes beyond the pool. With
    ``config.network_from_correlation`` the discovery network submatrices
    derive from the gathered correlation and ``disc_net`` is not read.
    ``mesh`` (one perm row of a row-sharded engine's) changes nothing
    here: where the JAX package's row-sharded engine gathers the
    discovery blocks by the sum of the row blocks' shares, each block is
    gathered where the matrix lies (a gather, so the same bits). With
    ``disc_corr`` None (data-only) every submatrix derives from the
    discovery data (:func:`~netrep_tpu_torch.atlas.modules.
    make_disc_props_data_only`).

    ``offsets`` (one per module): where each module slices the drawn
    permutation — a pack's request-local offsets, whose caller checks
    each request against the pool; default the cumulative sizes, checked
    here. ``cache`` ``(ObservedCache, digest, mode)`` looks each bucket's
    props up first and stores those it computes; only the missing buckets
    read the discovery matrices (none read, none copied to ``dev``, when
    every bucket hits)."""
    modules = list(modules)
    sizes = [m.size for m in modules]
    if min(sizes, default=1) < 2:
        bad = [m.label for m in modules if m.size < 2]
        raise ValueError(
            f"modules {bad} have fewer than 2 nodes present in the test "
            "dataset; preservation statistics are undefined"
        )
    if offsets is None:
        if int(np.sum(sizes)) > np.size(pool):
            raise ValueError(
                f"module sizes (total {int(np.sum(sizes))}) exceed the null "
                f"candidate pool ({np.size(pool)}); use null='all' or drop "
                "modules"
            )
        offsets = np.concatenate([[0], np.cumsum(sizes)])
    net_beta = config.network_from_correlation
    data_only = disc_corr is None
    by_cap: dict[int, list[int]] = {}
    for k, m in enumerate(modules):
        by_cap.setdefault(config.rounded_cap(m.size), []).append(k)
    pads, masks = {}, {}
    for cap, pos in by_cap.items():
        pads[cap] = np.stack([_pad_to(modules[k].disc_idx.astype(np.int32),
                                      cap) for k in pos])
        masks[cap] = np.zeros((len(pos), cap), np.float32)
        for r, k in enumerate(pos):
            masks[cap][r, : modules[k].size] = 1.0
    props, keys = {}, {}
    if cache is not None:
        store, digest, mode = cache
        for cap in sorted(by_cap):
            keys[cap] = store.props_key(digest, mode, cap, pads[cap],
                                        masks[cap])
            hit = store.get_props(keys[cap])
            if hit is not None:
                props[cap] = hit
    caps = [cap for cap in sorted(by_cap) if cap not in props]
    if caps:
        for cap, disc in zip(caps, _bucket_props(
                disc_corr, disc_net, disc_data, caps, pads, masks, net_beta,
                dev)):
            props[cap] = disc
            if cache is not None:
                store.put_props(keys[cap], disc)
    return [
        dict(cap=cap, module_pos=by_cap[cap], disc=props[cap],
             obs_idx=np.stack([_pad_to(modules[k].test_idx, cap)
                               for k in by_cap[cap]]),
             slices=[(int(offsets[k]), modules[k].size)
                     for k in by_cap[cap]])
        for cap in sorted(by_cap)
    ]


def _bucket_props(disc_corr, disc_net, disc_data, caps, pads, masks,
                  net_beta, dev) -> list:
    """The :class:`~netrep_tpu_torch.ops.stats.DiscProps` of the buckets
    ``caps`` (padded indices ``pads[cap]``, masks ``masks[cap]``) from one
    discovery side (see :func:`build_buckets`). Each bucket's padded
    blocks and data columns are gathered where the matrices lie and
    narrowed to float32 there (:func:`~netrep_tpu_torch.models.dataset.
    gather_block`: the bits of the narrowed matrix), and only they are
    copied to ``dev``, so no discovery ``n × n`` of the host reaches the
    card. The properties are computed on ``dev``."""
    data_only = disc_corr is None
    didxs = [torch.as_tensor(pads[cap].astype(np.int64), device=dev)
             for cap in caps]
    if data_only:
        # the submatrices derive from the transposed data's rows below
        dd = _as_f32(disc_data, dev)
        subs = [(None, None)] * len(caps)
    else:
        subs = []
        for cap in caps:
            sub_c = ds.gather_block(disc_corr, pads[cap], dev)
            subs.append((sub_c, tstats.derived_net(sub_c, net_beta)
                         if net_beta is not None
                         else ds.gather_block(disc_net, pads[cap], dev)))

    out = []
    for cap, didx, (sub_c, sub_n) in zip(caps, didxs, subs):
        mask = torch.as_tensor(masks[cap], device=dev)
        if data_only:
            out.append(make_disc_props_data_only(dd.T, didx, mask, net_beta))
            continue
        data = None if disc_data is None else ds.gather_columns(
            disc_data, pads[cap], dev).permute(1, 0, 2)
        out.append(tstats.make_disc_props(sub_c, sub_n, data, mask))
    return out


@dataclasses.dataclass
class Checkpointer:
    """Where and how often a null loop saves, and the identity its
    checkpoints carry: the key data of the permutation stream and the
    problem's fingerprint (:func:`checkpointer`)."""

    path: str
    every: int
    key_data: np.ndarray
    fingerprint: np.ndarray
    #: loop state that rides every save beside the loop's own extras and
    #: is restored on load (the screened null's
    #: :class:`~netrep_tpu_torch.parallel.screened.RescueState`)
    extra_state: object | None = None
    #: background writer of the run (under a fault policy), else None
    writer: ckpt.AsyncCheckpointWriter | None = None
    #: the run's mesh spans processes: process 0 alone writes, and every
    #: process resumes from what process 0 read
    shared: bool = False

    def load(self) -> dict | None:
        if self.shared:
            got, err = None, None
            if distributed.process_index() == 0:
                try:
                    got = ckpt.load_null_checkpoint(self.path)
                # netrep: allow(exception-taxonomy) — process 0's refusal is handed to every process and re-raised in each
                except Exception as e:
                    err = e
            got, err = distributed.broadcast_object((got, err))
            if err is not None:
                raise err
            loaded = got
        else:
            loaded = ckpt.load_null_checkpoint(self.path)
        if loaded is not None and self.extra_state is not None:
            self.extra_state.restore_state(loaded.get("extras") or {})
        return loaded

    def save(self, nulls, done: int, extra: dict | None = None) -> None:
        if self.shared and distributed.process_index() != 0:
            return
        if self.extra_state is not None:
            extra = {**(extra or {}), **self.extra_state.state_arrays()}
        ckpt.save_null_checkpoint(self.path, nulls, done, self.key_data,
                                  self.fingerprint, extra=extra,
                                  writer=self.writer)

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()

    def close(self) -> None:
        """Drain and stop the background writer; later saves are
        synchronous. A loop closes it after its last save (which then
        supersedes a still-queued one) or, on an error, after the
        failure-save and before the error reaches the ladder."""
        if self.writer is not None:
            self.writer.close()


#: namespace of the streaming loops' checkpoint identity: a streaming
#: checkpoint never resumes a materialized run and the reverse (the JAX
#: package's ``_STREAM_FP``)
_STREAM_FP = b"stream-counts|"


def checkpointer(engine, key: trandom.ThreefryKey, path: str | None,
                 every: int, fingerprint_extra: bytes = b"",
                 extra_state=None) -> Checkpointer | None:
    """The :class:`Checkpointer` of a run at ``path`` (None: no
    checkpoints). Its identity is the JAX package's, byte for byte, for
    the same problem and seed (``netrep_tpu/parallel/engine.py::
    _checkpoint_identity``): the key's words and the engine's fingerprint
    with ``fingerprint_extra`` appended. As there, the storage type is not
    part of it, nor is the mesh. On a mesh that spans processes the
    checkpoint is shared (:attr:`Checkpointer.shared`)."""
    if path is None:
        return None
    engine.fingerprint_digest()  # raises without a checkpoint identity
    fp = ckpt.engine_fingerprint(engine)
    if fingerprint_extra:
        fp = np.concatenate(
            [fp, np.frombuffer(fingerprint_extra, dtype=np.uint8)])
    mesh = getattr(engine, "mesh", None)
    return Checkpointer(str(path), int(every), key.data(), fp, extra_state,
                        shared=mesh is not None and mesh.spans_processes)


def chunk_counts(stream_parts: Callable, monitor,
                 to_active: Callable) -> Callable:
    """``build(guarded) -> (counts(keys, valid), commit)`` for
    :func:`run_adaptive_stream_chunks`: ``stream_parts()`` gives the
    ``(count, pull, tallies)`` of the current buckets, and ``counts``
    returns a chunk's ``(hi, lo, eff)``, ``to_active(delta, positions)``
    reshaping each to the monitor's ``(n_active, n_cells)``, and what
    ``commit`` takes. Unguarded, the chunk folds into the run's tallies
    and its counts are the difference of two host reads (one copy each).
    Guarded (under a fault policy), it folds into fresh tallies
    (:meth:`Tallies.fresh`), read once, which ``commit`` adds to the
    run's on the loop thread — an abandoned dispatch commits nothing."""

    def build(guarded: bool):
        count, pull, tallies = stream_parts()
        last = [None if guarded else pull(tallies)]

        def counts(keys, valid):
            pos = monitor.active_positions()
            if guarded:
                acc = count(keys, valid, tallies.fresh())
                return tuple(to_active(a, pos) for a in pull(acc)), acc
            count(keys, valid, tallies)
            now = pull(tallies)
            out = tuple(to_active(a - b, pos) for a, b in zip(now, last[0]))
            last[0] = now
            return out, None

        def commit(acc):
            if acc is not None:
                tallies.add_(acc)

        return counts, commit

    return build


class Tallies(NamedTuple):
    """A streaming null's exceedance tallies: ``dev``, the per-bucket
    ``[hi, lo, eff]`` int32 device tensors (nested lists, per shard or per
    cohort first); ``host``, int64 host arrays beside them (the screened
    null's rescued tallies and its rescue counters since the last
    pull); ``state``, the screened run's :class:`~netrep_tpu_torch.
    parallel.screened.RescueState` counters (which its ``pull``
    advances), or None. Under a fault policy each guarded dispatch folds
    into :meth:`fresh` tallies that :meth:`add_` commits on the loop thread
    once the dispatch has returned: a retried dispatch starts from zero,
    and an abandoned one that is still running writes only into tallies
    nobody reads (the JAX package rebuilds its donated tally carry
    instead)."""

    dev: list
    host: tuple = ()
    state: object = None

    def fresh(self) -> "Tallies":
        """Zeroed tallies of the same layout and devices."""
        return Tallies(
            _map_tensors(torch.zeros_like, self.dev),
            tuple(np.zeros_like(h) for h in self.host),
            None if self.state is None else type(self.state)())

    def add_(self, other: "Tallies") -> None:
        """Add ``other`` into these tallies in place."""
        for t, d in zip(_flat_tensors(self.dev), _flat_tensors(other.dev)):
            t += d
        for h, d in zip(self.host, other.host):
            h += d
        if self.state is not None:
            for name, v in vars(other.state).items():
                setattr(self.state, name, getattr(self.state, name) + v)


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return [_map_tensors(fn, sub) for sub in tree]


def _flat_tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in _flat_tensors(sub)]


def _run_hooks(telemetry, profile, fault_policy, ck, device, engine=None,
               counting=False, mesh=None):
    """Once per run: the telemetry bus (explicit or ambient), a
    :class:`~netrep_tpu_torch.utils.profiling.NullProfile` when telemetry
    is on, the fault runtime (told whether the run's ``mesh`` spans
    processes: :attr:`~netrep_tpu_torch.utils.faults.FaultRuntime.
    across`), the checkpointer's background writer under a
    policy, the per-chunk memory probe and ``engine``'s roofline cost
    tracker (:func:`~netrep_tpu_torch.utils.costmodel.tracker_for`;
    ``counting`` for the streaming loops). The flight recorder's bus
    (``flight_only``) gets neither the probe nor the tracker: a run it
    alone observes stays pure host-side bookkeeping."""
    telemetry = tm.resolve(telemetry)
    if telemetry is not None and profile is None:
        profile = NullProfile()
    ft = flt.resolve_runtime(fault_policy)
    if ft is not None:
        ft.across = ((distributed.process_index(),
                      distributed.process_count(),
                      None if ck is None else ck.path)
                     if mesh is not None and mesh.spans_processes else None)
    if ck is not None and ft is not None and ft.policy.async_checkpoint:
        ck.writer = ckpt.AsyncCheckpointWriter(telemetry)
    live = telemetry is not None and not _flight_only(telemetry)
    mem = make_memory_probe(device) if live and device is not None else None
    tracker = (costmodel.tracker_for(engine, counting)
               if live and engine is not None else None)
    return telemetry, profile, ft, mem, tracker


def _flight_only(telemetry) -> bool:
    """Whether ``telemetry`` is the flight recorder's ambient bus."""
    return getattr(telemetry, "flight_only", False)


def _arm(telemetry, ft, rescue):
    """The run's stall watchdog (None without telemetry), wired to the
    fault runtime's warn → act escalation under a policy. Only a run whose
    watchdog thread runs (``watchdog_poll_s > 0``) wires it: the wiring
    runs every dispatch on a worker thread the watchdog can walk away
    from, which without a watchdog thread would cost a thread a dispatch
    for an escalation nothing can fire (the JAX package wires it under any
    policy; the events are the same)."""
    if telemetry is None or _flight_only(telemetry):
        return None
    if ft is None or telemetry.watchdog_poll_s <= 0:
        return tm.arm_watchdog(telemetry)
    action, factor = ft.watchdog_escalation(rescue)
    return tm.arm_watchdog(telemetry, action=action, action_factor=factor)


def _totals(profile) -> tuple[int, int]:
    return ((profile.dispatches, profile.host_bytes)
            if profile is not None else (0, 0))


def _nbytes(tree) -> int:
    """Bytes of the tensors and arrays of a chunk's outputs (what its host
    copy moves, a tail chunk's padding included)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(t) for t in tree)
    return 0


def _finish_run(telemetry, run_sid, t_marks, t_run0, start, mode,
                run_key: str, n_perm: int, tracker=None,
                device=None, engine=None) -> None:
    """End of a run's accounting, once at least two chunks landed: a
    ``compile_span`` event, the first interval's surplus over the steady
    rate of marks 0 → last — the first chunk's kernel build or load and
    first-touch costs, as the JAX package estimates its jit compile, with
    the ``source`` of the kernel libraries the run's engine acquired
    (:func:`~netrep_tpu_torch.utils.aot.run_source`: ``jit``, ``aot`` or
    ``memo``); with
    a cost tracker the ``roofline`` event at that steady rate, also kept
    as the process's and the bus's last-run note (a server's ``stats()``
    reads its own bus's); and
    the perf ledger's run entry (:func:`~netrep_tpu_torch.utils.
    perfledger.maybe_record_run`, when ``NETREP_PERF_LEDGER`` names one),
    keyed by the engine's ``run_key`` with the ``|src:`` suffix, so warm
    and cold histories never mix. A run only the flight recorder
    observes writes neither the note nor the ledger."""
    if len(t_marks) < 2:
        return
    (c0, t0), (c1, t1) = t_marks[0], t_marks[-1]
    if t1 <= t0 or c1 <= c0:
        return
    rate = (c1 - c0) / (t1 - t0)
    compile_s = max(0.0, (t0 - t_run0) - (c0 - start) / rate)
    src = aot.run_source(getattr(engine, "_lib_mark", None))
    telemetry.emit("compile_span", parent=run_sid, s=compile_s,
                   key=run_key, mode=mode, source=src)
    roofline = None
    if tracker is not None:
        roofline = tracker.roofline_block(rate)
        telemetry.emit("roofline", parent=run_sid, mode=mode, **roofline)
        costmodel.record_run_note(roofline, bus=telemetry)
    if _flight_only(telemetry) or distributed.process_index() != 0:
        return
    perfledger.maybe_record_run(
        f"{run_key}|src:{src}" if run_key else run_key, rate, mode,
        backend="cuda" if device is None else torch.device(device).type,
        compile_s=compile_s, n_perm=int(n_perm), run_id=telemetry.run_id,
        roofline=roofline)


def run_checkpointed_chunks(key, n_perm: int, C: int, chunk: Callable,
                            write: Callable, alloc_shape: tuple,
                            progress=None, ck: Checkpointer | None = None,
                            perm_axis: int = 0, full: bool = False,
                            fault_policy=None, telemetry=None, profile=None,
                            device=None, run_key: str = "", engine=None,
                            perm_keys: Callable | None = None, mesh=None
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
    ``(nulls, completed)``, NaN past ``completed``.

    ``fault_policy`` (a :class:`~netrep_tpu_torch.utils.config.
    FaultPolicy`, a :class:`~netrep_tpu_torch.utils.faults.FaultRuntime`,
    True, or None) runs every chunk under the fault ladder
    (:meth:`~netrep_tpu_torch.utils.faults.FaultRuntime.run_dispatch`):
    the chunk's kernels are waited on inside the retry scope, periodic
    saves go through a background writer, and at each chunk boundary a
    pending grow-back raises :class:`~netrep_tpu_torch.utils.faults.
    CapacityRestoredError` past the failure-save; on a ``mesh`` that
    spans processes an abandoned dispatch raises :class:`~netrep_tpu_torch.
    utils.faults.CrossProcessRungError` past it instead of re-dispatching
    (the chunk ends in a collective). ``telemetry`` (or the
    ambient bus) gets the run span, one ``dispatch`` and one ``chunk``
    event per chunk (``device``'s memory gauges on a card), a
    ``compile_span`` and a stall watchdog; ``profile`` counts dispatches
    and host bytes. With ``engine`` (the run's engine, whose buckets the
    cost model prices) telemetry also gets each chunk's cost fields, the
    run's ``roofline`` event and its perf-ledger entry (:func:`_finish_run`),
    and ``profile`` the cost totals. With all of them None the loop is as
    it was.

    ``perm_keys(key, start, count)`` gives a chunk's ``keys`` (default
    :func:`~netrep_tpu_torch.random.perm_keys`): the native tier passes
    its own, whose key is an integer seed and whose chunk is the triple
    ``(seed, start, count)`` of its counter-based stream."""
    telemetry, profile, ft, mem, tracker = _run_hooks(
        telemetry, profile, fault_policy, ck, device, engine, mesh=mesh)
    perm_keys = perm_keys or trandom.perm_keys
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
    t_marks: list[tuple[int, float]] = []

    def rescue():
        # emergency checkpoint of committed work, from the fault runtime
        # (abandon) or the watchdog thread (warn → act)
        if ck is not None and completed > last_saved:
            ck.save(nulls, completed)
            ck.flush()

    wd = _arm(telemetry, ft, rescue)
    prev_t = t_run0 = time.perf_counter()
    d0, b0 = prev_d, prev_b = _totals(profile)
    run_sid = None
    if telemetry is not None:
        run_sid = telemetry.begin_span(
            "null_run_start", mode="materialized", n_perm=int(n_perm),
            start_perm=int(start))
    try:
        while dispatched < n_perm or pending is not None:
            if ft is not None and ck is not None:
                ft.check_grow()
            nxt = None
            if dispatched < n_perm:
                take = min(C, n_perm - dispatched)
                keys = perm_keys(key, dispatched, C if full else take)
                sid_c = None
                if telemetry is not None:
                    sid_c = telemetry.new_span_id()
                    t_d0 = time.perf_counter()
                with (telemetry.pushed(sid_c) if telemetry is not None
                      else contextlib.nullcontext()):
                    outs = (chunk(keys) if ft is None else ft.run_dispatch(
                        lambda: chunk(keys), start=dispatched, take=take,
                        telemetry=telemetry, rescue=rescue))
                if telemetry is not None:
                    telemetry.emit("dispatch", parent=sid_c,
                                   s=time.perf_counter() - t_d0,
                                   start=int(dispatched), take=int(take))
                nxt = (outs, dispatched, take, sid_c)
                dispatched += take
                if profile is not None:
                    profile.record_dispatch(2)  # key derivation + chunk
            if pending is not None:
                outs, at, take_p, sid_p = pending
                t_w0 = time.perf_counter()
                write(nulls, outs, at, take_p)
                completed = at + take_p
                t_marks.append((completed, time.perf_counter()))
                if profile is not None:
                    profile.record_transfer(_nbytes(outs))
                if telemetry is not None:
                    now = t_marks[-1][1]
                    d, b = _totals(profile)
                    telemetry.emit(
                        "chunk", done=int(completed), total=int(n_perm),
                        take=int(take_p), s=now - prev_t,
                        dispatches=d - prev_d, host_bytes=b - prev_b,
                        transfer_s=now - t_w0, span=sid_p, parent=run_sid,
                        **(tracker.chunk_fields(int(take_p), now - prev_t,
                                                profile)
                           if tracker is not None else {}),
                        **(mem() if mem is not None else {}))
                    prev_t, prev_d, prev_b = now, d, b
                    if wd is not None:
                        wd.beat()
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
                outs, at, take_p, _sid = pending
                write(nulls, outs, at, take_p)
                completed = at + take_p
            except KeyboardInterrupt:
                pass
    except BaseException:
        if pending is not None:
            try:
                outs, at, take_p, _sid = pending
                write(nulls, outs, at, take_p)
                completed = at + take_p
            # netrep: allow(exception-taxonomy) — failure-unwind flush of already-computed work on a possibly-dead device; the original error re-raises just below
            except Exception:
                pass
        if ck is not None:
            if completed > last_saved:
                ck.save(nulls, completed)
            ck.close()
        raise
    finally:
        if wd is not None:
            wd.stop()
    if ck is not None:
        try:
            if completed > last_saved:
                ck.save(nulls, completed)
        finally:
            ck.close()
    if telemetry is not None:
        d, b = _totals(profile)
        _finish_run(telemetry, run_sid, t_marks, t_run0, start,
                    "materialized", run_key, n_perm, tracker, device,
                    engine)
        el = time.perf_counter() - t_run0
        telemetry.end_span(
            run_sid, "null_run_end", mode="materialized",
            completed=int(completed), n_perm=int(n_perm),
            s=el, dispatches=d - d0, host_bytes=b - b0,
            **(tracker.run_fields(el) if tracker is not None else {}))
    return nulls, completed


def run_stream_superchunks(key, n_perm: int, C: int, K: int,
                           count: Callable, pull: Callable, tallies: Tallies,
                           progress=None, ck: Checkpointer | None = None,
                           fault_policy=None, telemetry=None, profile=None,
                           device=None, run_key: str = "", engine=None,
                           mesh=None):
    """The streaming null loop: ``count(keys, valid, tallies)`` folds a
    chunk's tallies into ``tallies`` on the device; ``pull(tallies)``
    reads them to the host once per superchunk of ``K`` chunks. Chunk j
    of a superchunk starting at ``done`` draws ``fold_in(key, done + j*C +
    i)`` — the permutations the materialized loop draws at the same
    indices — and its tail past ``n_perm`` is gated off.

    With a :class:`Checkpointer` the ``(hi, lo, eff)`` tallies are saved
    at superchunk boundaries (``stream_*`` extras beside an empty null, the
    identity in the streaming namespace) and resumed: the device then
    counts from zero and the saved tallies are added on the host. A
    ``KeyboardInterrupt`` returns the tallies of the last whole superchunk
    (tallies and counter commit in one statement). Returns ``((hi, lo,
    eff), completed)``.

    ``fault_policy``, ``telemetry`` and ``profile`` as in
    :func:`run_checkpointed_chunks`, per superchunk: the superchunk's K
    counts are one guarded dispatch (``label='superchunk'``) that folds
    into :meth:`Tallies.fresh` tallies and returns them, its kernels
    waited on; the loop adds them to ``tallies`` once the dispatch has
    returned, so a retried or abandoned superchunk never counts twice.

    With at least two superchunk marks the steady rate from the first
    mark to the last goes to ``engine.record_stream_throughput`` (the
    autotune store), as in the JAX package."""
    telemetry, profile, ft, mem, tracker = _run_hooks(
        telemetry, profile, fault_policy, ck, device, engine, counting=True,
        mesh=mesh)
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
        now = pull(tallies)
        return now if base is None else tuple(b + t
                                              for b, t in zip(base, now))

    def save(counts, done):
        ck.save(np.zeros((0,)), done,
                extra=dict(zip(("stream_hi", "stream_lo", "stream_eff"),
                               counts)))

    def superchunk(done, acc):
        for j in range(K):
            valid = min(C, n_perm - done - j * C)
            if valid <= 0:
                break
            count(trandom.perm_keys(key, done + j * C, C), valid, acc)
        return acc

    counts = total()
    start = last_saved = completed
    t_marks: list[tuple[int, float]] = []

    def rescue():
        # committed tallies only: safe from the watchdog thread
        if ck is not None and completed > last_saved:
            save(counts, completed)
            ck.flush()

    wd = _arm(telemetry, ft, rescue)
    prev_t = t_run0 = time.perf_counter()
    d0, b0 = _totals(profile)
    run_sid = None
    if telemetry is not None:
        run_sid = telemetry.begin_span(
            "null_run_start", mode="streaming", n_perm=int(n_perm),
            start_perm=int(completed), superchunk=int(K), chunk=int(C))
    try:
        while completed < n_perm:
            if ft is not None and ck is not None:
                ft.check_grow()
            take = min(K * C, n_perm - completed)
            sid_c = None
            if telemetry is not None:
                sid_c = telemetry.new_span_id()
                t_d0 = time.perf_counter()
            with (telemetry.pushed(sid_c) if telemetry is not None
                  else contextlib.nullcontext()):
                if ft is None:
                    superchunk(completed, tallies)
                else:
                    tallies.add_(ft.run_dispatch(
                        lambda: superchunk(completed, tallies.fresh()),
                        start=completed, take=take, telemetry=telemetry,
                        rescue=rescue, label="superchunk"))
            if telemetry is not None:
                telemetry.emit("dispatch", parent=sid_c,
                               s=time.perf_counter() - t_d0,
                               start=int(completed), take=int(take))
            t_p0 = time.perf_counter()
            counts, completed = total(), completed + take
            t_marks.append((completed, time.perf_counter()))
            if profile is not None:
                nbytes = sum(c.nbytes for c in counts)
                profile.record_dispatch(2)  # key derivation + superchunk
                profile.record_transfer(nbytes)
                profile.record_superchunk(2, nbytes, take)
            if telemetry is not None:
                now = t_marks[-1][1]
                telemetry.emit(
                    "superchunk", done=int(completed), total=int(n_perm),
                    perms=int(take), s=now - prev_t, dispatches=2,
                    host_bytes=int(sum(c.nbytes for c in counts)),
                    transfer_s=now - t_p0, span=sid_c, parent=run_sid,
                    **(tracker.chunk_fields(int(take), now - prev_t, profile)
                       if tracker is not None else {}),
                    **(mem() if mem is not None else {}))
                prev_t = now
                if wd is not None:
                    wd.beat()
            if progress is not None:
                progress(completed, n_perm)
            if ck is not None and completed - last_saved >= ck.every:
                save(counts, completed)
                last_saved = completed
    except KeyboardInterrupt:
        pass
    except BaseException:
        if ck is not None:
            if completed > last_saved:
                save(counts, completed)
            ck.close()
        raise
    finally:
        if wd is not None:
            wd.stop()
    if ck is not None:
        try:
            if completed > last_saved:
                save(counts, completed)
        finally:
            ck.close()
    record = getattr(engine, "record_stream_throughput", None)
    if record is not None and len(t_marks) >= 2:
        # the steady rate of marks 0 → last: the interval before mark 0
        # holds the first superchunk's kernel build or load
        (c0, t0), (c1, t1) = t_marks[0], t_marks[-1]
        if t1 > t0 and c1 > c0:
            record((c1 - c0) / (t1 - t0))
    if telemetry is not None:
        _finish_run(telemetry, run_sid, t_marks, t_run0, start,
                    "streaming", run_key, n_perm, tracker, device, engine)
        d, b = _totals(profile)
        el = time.perf_counter() - t_run0
        telemetry.end_span(
            run_sid, "null_run_end", mode="streaming",
            completed=int(completed), n_perm=int(n_perm),
            s=el, dispatches=d - d0, host_bytes=b - b0,
            **(tracker.run_fields(el) if tracker is not None else {}))
    return counts, completed


def resolve_stream_superchunk(engine, key: str) -> int:
    """The superchunk of one streaming run of ``engine`` under the
    autotune ``key`` (:func:`~netrep_tpu_torch.utils.autotune.
    resolve_superchunk`), with the recording handle kept as
    ``engine._stream_autotune_record``. On a mesh that spans processes
    process 0 resolves and broadcasts, and only it records: the tallies
    are summed across processes once a superchunk, so every rank must
    run the same number of them."""
    mesh = engine.mesh
    spans = mesh is not None and mesh.spans_processes
    if spans and distributed.process_index() != 0:
        K, cache = int(distributed.broadcast_object(None)), None
    else:
        K, cache = autotune.resolve_superchunk(engine.config, key,
                                               device=engine.device)
        if spans:
            distributed.broadcast_object(int(K))
    engine._stream_autotune_record = (
        (cache, key, K) if cache is not None else None)
    return K


def run_adaptive_chunks(key, n_perm: int, C: int, chunk: Callable,
                        write: Callable, alloc_shape: tuple,
                        slice_vals: Callable, monitor, rebucket: Callable,
                        progress=None, ck: Checkpointer | None = None,
                        perm_axis: int = 0, full: bool = False,
                        fault_policy=None, telemetry=None, device=None,
                        run_key: str = "", engine=None, mesh=None
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
    ``KeyboardInterrupt``. ``fault_policy`` and ``telemetry`` as in
    :func:`run_checkpointed_chunks` (the monitor emits ``module_retired``
    on the bus); decisions are unaffected, since tallies fold only from
    committed chunks and a retried chunk draws the same keys. With
    telemetry on, a monitor that attributes costs (a pack's
    ``note_chunk_cost``) gets each chunk's dispatch and host-copy seconds
    after folding it."""
    telemetry, _profile, ft, mem, tracker = _run_hooks(
        telemetry, None, fault_policy, ck, device, engine, mesh=mesh)
    monitor.telemetry = telemetry
    note_cost = (getattr(monitor, "note_chunk_cost", None)
                 if telemetry is not None else None)
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
    start = last_saved = completed
    finished = True
    t_marks: list[tuple[int, float]] = []

    def rescue():
        # whole written-and-folded chunks only: a consistent prefix
        if ck is not None and completed > last_saved:
            ck.save(nulls, completed, extra=monitor.state_arrays())
            ck.flush()

    wd = _arm(telemetry, ft, rescue)
    prev_t = t_run0 = time.perf_counter()
    run_sid = None
    if telemetry is not None:
        run_sid = telemetry.begin_span(
            "null_run_start", mode="adaptive", n_perm=int(n_perm),
            start_perm=int(completed), chunk=int(C))
    try:
        while completed < n_perm and monitor.any_active():
            if ft is not None and ck is not None:
                ft.check_grow()
            pos = monitor.active_positions()
            take = min(C, n_perm - completed)
            keys = trandom.perm_keys(key, completed, C if full else take)
            sid_c = None
            if telemetry is not None:
                sid_c = telemetry.new_span_id()
                t_d0 = time.perf_counter()
            with (telemetry.pushed(sid_c) if telemetry is not None
                  else contextlib.nullcontext()):
                outs = (chunk(keys) if ft is None else ft.run_dispatch(
                    lambda: chunk(keys), start=completed, take=take,
                    telemetry=telemetry, rescue=rescue))
            if telemetry is not None:
                disp_s = time.perf_counter() - t_d0
                telemetry.emit("dispatch", parent=sid_c, s=disp_s,
                               start=int(completed), take=int(take))
            t_w0 = time.perf_counter()
            write(nulls, outs, completed, take)
            write_s = time.perf_counter() - t_w0
            completed += take
            newly = monitor.update(
                slice_vals(nulls, completed - take, take, pos), take)
            if note_cost is not None:
                note_cost(disp_s, write_s)
            if telemetry is not None:
                now = time.perf_counter()
                t_marks.append((completed, now))
                telemetry.emit(
                    "chunk", done=int(completed), total=int(n_perm),
                    take=int(take), s=now - prev_t,
                    active_modules=int(monitor.active.sum()),
                    transfer_s=now - t_w0, span=sid_c, parent=run_sid,
                    **(tracker.chunk_fields(int(take), now - prev_t)
                       if tracker is not None else {}),
                    **(mem() if mem is not None else {}))
                prev_t = now
                if wd is not None:
                    wd.beat()
            if progress is not None:
                progress(completed, n_perm)
            if newly.size and monitor.any_active():
                rebucket(monitor.active_positions())
                if tracker is not None:
                    # retirement shrank the buckets: later chunks cost less
                    tracker.refresh(engine)
            if ck is not None and completed - last_saved >= ck.every:
                ck.save(nulls, completed, extra=monitor.state_arrays())
                last_saved = completed
    except KeyboardInterrupt:
        finished = False
    except BaseException:
        if ck is not None:
            if completed > last_saved:
                ck.save(nulls, completed, extra=monitor.state_arrays())
            ck.close()
        raise
    finally:
        if wd is not None:
            wd.stop()
    if ck is not None:
        try:
            if completed > last_saved:
                ck.save(nulls, completed, extra=monitor.state_arrays())
        finally:
            ck.close()
    if telemetry is not None:
        _finish_run(telemetry, run_sid, t_marks, t_run0, start, "adaptive",
                    run_key, n_perm, tracker, device, engine)
        el = time.perf_counter() - t_run0
        telemetry.end_span(
            run_sid, "null_run_end", mode="adaptive",
            completed=int(completed), n_perm=int(n_perm), s=el,
            perms_evaluated=int(monitor.total_evaluated()),
            **(tracker.run_fields(el) if tracker is not None else {}))
    return nulls, completed, finished


def run_adaptive_stream_chunks(key, n_perm: int, C: int,
                               make_counts: Callable, monitor,
                               rebucket: Callable, progress=None,
                               ck: Checkpointer | None = None,
                               fault_policy=None, telemetry=None,
                               profile=None, device=None, run_key: str = "",
                               engine=None, mesh=None) -> tuple[int, bool]:
    """The streaming adaptive loop: one chunk per dispatch, so decisions
    land at the chunk boundaries the materialized adaptive loop takes
    them at, but the dispatch returns each active module's ``(hi, lo,
    eff)`` tallies of the chunk and the monitor folds them
    (:meth:`~netrep_tpu_torch.ops.sequential.StopMonitor.update_counts`).
    The kernel's tallies compare the same float32 values the materialized
    loop widens, so retirement is the same in both modes.

    ``make_counts(guarded)`` returns ``(counts, commit)``
    (:func:`chunk_counts`): ``counts(keys, valid) -> ((hi, lo, eff),
    acc)`` over the active modules in ``monitor.active_positions()``
    order for the current buckets (rebuilt after each re-bucketing), and
    ``commit(acc)`` on this thread after the dispatch returned; under a
    policy the chunk folds into fresh tallies, so an abandoned dispatch
    commits nothing. Counts and
    monitor commit together, so a checkpoint (the monitor's state in the
    streaming namespace) has no unfolded gap. ``fault_policy``,
    ``telemetry`` and ``profile`` as in :func:`run_checkpointed_chunks`.
    Returns ``(completed, finished)``."""
    telemetry, profile, ft, mem, tracker = _run_hooks(
        telemetry, profile, fault_policy, ck, device, engine, counting=True,
        mesh=mesh)
    monitor.telemetry = telemetry
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
    counts, commit = (make_counts(ft is not None) if monitor.any_active()
                      else (None, None))
    start = last_saved = completed
    finished = True
    t_marks: list[tuple[int, float]] = []

    def rescue():
        # the monitor folds whole chunks: its state is always consistent
        if ck is not None and completed > last_saved:
            save(completed)
            ck.flush()

    wd = _arm(telemetry, ft, rescue)
    prev_t = t_run0 = time.perf_counter()
    d0, b0 = _totals(profile)
    run_sid = None
    if telemetry is not None:
        run_sid = telemetry.begin_span(
            "null_run_start", mode="adaptive-streaming", n_perm=int(n_perm),
            start_perm=int(completed), chunk=int(C))
    try:
        while completed < n_perm and monitor.any_active():
            if ft is not None and ck is not None:
                ft.check_grow()
            take = min(C, n_perm - completed)
            keys = trandom.perm_keys(key, completed, C)
            sid_c = None
            if telemetry is not None:
                sid_c = telemetry.new_span_id()
                t_d0 = time.perf_counter()
            with (telemetry.pushed(sid_c) if telemetry is not None
                  else contextlib.nullcontext()):
                (hi, lo, eff), acc = (
                    counts(keys, take) if ft is None else ft.run_dispatch(
                        lambda: counts(keys, take), start=completed,
                        take=take, telemetry=telemetry, rescue=rescue))
            if telemetry is not None:
                telemetry.emit("dispatch", parent=sid_c,
                               s=time.perf_counter() - t_d0,
                               start=int(completed), take=int(take))
            if profile is not None:
                profile.record_dispatch(2)
                profile.record_transfer(hi.nbytes + lo.nbytes + eff.nbytes)
            newly = monitor.update_counts(hi, lo, take, eff=eff)
            commit(acc)
            completed = monitor.folded
            if telemetry is not None:
                now = time.perf_counter()
                t_marks.append((completed, now))
                telemetry.emit(
                    "chunk", done=int(completed), total=int(n_perm),
                    take=int(take), s=now - prev_t, dispatches=2,
                    host_bytes=int(hi.nbytes + lo.nbytes + eff.nbytes),
                    active_modules=int(monitor.active.sum()),
                    span=sid_c, parent=run_sid,
                    **(tracker.chunk_fields(int(take), now - prev_t, profile)
                       if tracker is not None else {}),
                    **(mem() if mem is not None else {}))
                prev_t = now
                if wd is not None:
                    wd.beat()
            if progress is not None:
                progress(completed, n_perm)
            if newly.size and monitor.any_active():
                rebucket(monitor.active_positions())
                counts, commit = make_counts(ft is not None)
                if tracker is not None:
                    tracker.refresh(engine)
            if ck is not None and completed - last_saved >= ck.every:
                save(completed)
                last_saved = completed
    except KeyboardInterrupt:
        finished = False
        completed = monitor.folded
    except BaseException:
        completed = monitor.folded
        if ck is not None:
            if completed > last_saved:
                save(completed)
            ck.close()
        raise
    finally:
        if wd is not None:
            wd.stop()
    if ck is not None:
        try:
            if completed > last_saved:
                save(completed)
        finally:
            ck.close()
    if telemetry is not None:
        d, b = _totals(profile)
        _finish_run(telemetry, run_sid, t_marks, t_run0, start,
                    "adaptive-streaming", run_key, n_perm, tracker, device,
                    engine)
        el = time.perf_counter() - t_run0
        telemetry.end_span(
            run_sid, "null_run_end", mode="adaptive-streaming",
            completed=int(completed), n_perm=int(n_perm),
            s=el, dispatches=d - d0, host_bytes=b - b0,
            perms_evaluated=int(monitor.total_evaluated()),
            **(tracker.run_fields(el) if tracker is not None else {}))
    return completed, finished


def root_key(key, device) -> trandom.ThreefryKey:
    """A :class:`~netrep_tpu_torch.random.ThreefryKey` on ``device`` from
    an integer seed or a key."""
    if isinstance(key, trandom.ThreefryKey):
        return key.to(device)
    # netrep: allow(rng-discipline) — THE seeding contract's root-key site: every fold_in stream derives from exactly this key
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
                    config: EngineConfig, dev, mesh: Mesh | None = None,
                    offsets=None, cache=None) -> list[dict]:
    """The discovery half of an engine build: the buckets of
    :func:`build_buckets`, after the checks that come first (data-only,
    :func:`check_data_only`; the ``matrix_sharding`` knob against
    ``mesh``; with ``config.network_from_correlation`` the discovery
    network against the construction). On a row-sharded mesh the
    discovery matrices are gathered through perm shard 0's row blocks.
    Once every pair's buckets exist, no discovery matrix is read again
    (``from_parts`` takes them). ``offsets`` and ``cache`` as in
    :func:`build_buckets`."""
    data_only = disc_corr is None and disc_net is None
    if data_only:
        check_data_only(config, disc_data is not None)
    row = _check_sharding(config, mesh)
    net_beta = config.network_from_correlation
    if net_beta is not None and not data_only:
        check_derived_network(disc_corr, disc_net, net_beta, "discovery")
    return build_buckets(disc_corr, disc_net, disc_data, modules,
                         np.asarray(pool, dtype=np.int32), config, dev,
                         mesh=mesh.perm_row(0) if row else None,
                         offsets=offsets, cache=cache)


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
    float32 (a float32 tensor already there is used as it is), and the test
    side is then narrowed to ``config.dtype``. With
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

    ``observed_cache``: an :class:`ObservedCache` (the grid's) through
    which the engine builds its discovery props and its observed
    statistics, sharing them with every engine over the same discovery
    side (props) or the same problem (observed).
    """

    #: the shared dedup cache (None: none)
    _observed_cache: ObservedCache | None = None

    def __init__(self, disc_corr, disc_net, disc_data, test_corr, test_net,
                 test_data, modules: Sequence[ModuleSpec], pool,
                 config: EngineConfig = EngineConfig(), device=None,
                 mesh: Mesh | None = None,
                 observed_cache: ObservedCache | None = None):
        dev = tmesh.resolve_device(mesh, device)
        #: the kernel-library acquisitions this engine's runs account for
        self._lib_mark = aot.mark()
        modules = list(modules)
        has_data = disc_data is not None and test_data is not None
        net_beta = config.network_from_correlation
        data_only = all(m is None for m in (disc_corr, disc_net, test_corr,
                                            test_net))
        pool = np.asarray(pool, dtype=np.int32)
        self._observed_cache = observed_cache
        buckets = self._build_buckets(disc_corr, disc_net,
                                      disc_data if has_data else None,
                                      modules, pool, config, dev, mesh)
        if net_beta is not None and not data_only:
            check_derived_network(test_corr, test_net, net_beta, "test")
        # the test data is kept TRANSPOSED, (n, n_samples): a module's data
        # slice is then a gather of contiguous rows
        st = config.torch_dtype
        self._setup(
            None if data_only else _as_stored(test_corr, dev, st),
            None if net_beta is not None else _as_stored(test_net, dev, st),
            _as_stored(test_data, dev, st).T if has_data else None,
            pool, buckets, len(modules), config, dev, mesh,
        )
        self.modules = modules
        # the checkpoint identity digests the inputs as given, as the JAX
        # engine does, so the two packages fingerprint a problem alike
        self._digest = ckpt.content_digest(
            [disc_corr, disc_net, disc_data, test_corr, test_net, test_data])

    def _slice_offsets(self, modules) -> np.ndarray | None:
        """Where each module slices the drawn permutation; None: the
        cumulative sizes, the reference's disjoint label shuffle, checked
        against the pool (a pack gives request-local offsets)."""
        return None

    def _build_buckets(self, disc_corr, disc_net, disc_data, modules, pool,
                       config, dev, mesh) -> list[dict]:
        """The engine's discovery buckets (:func:`build_discovery`), their
        props through the observed cache's props map when the engine has
        one."""
        cache = None
        if self._observed_cache is not None:
            cache = (self._observed_cache,
                     ckpt.content_digest([disc_corr, disc_net, disc_data]),
                     props_mode(disc_corr is None and disc_net is None,
                                _check_sharding(config, mesh),
                                config.network_from_correlation,
                                disc_data is not None))
        return build_discovery(disc_corr, disc_net, disc_data, modules, pool,
                               config, dev, mesh,
                               offsets=self._slice_offsets(modules),
                               cache=cache)

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
        self._lib_mark = aot.mark()
        dev = tmesh.resolve_device(mesh, device)

        def f32(a):
            return _as_f32(a, dev)

        def stored(a):
            return _as_stored(a, dev, config.torch_dtype)

        derived = config.network_from_correlation is not None
        self._setup(
            None if test_corr is None else stored(test_corr),
            None if derived or test_net is None else stored(test_net),
            None if test_dataT is None else stored(test_dataT),
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
        # the storage type: float32 inputs narrowed once (no copy when
        # they already are the type)
        st = config.torch_dtype
        tc, tn, tdT = (None if a is None else a.to(st) for a in (tc, tn, tdT))
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
        if config.null_precision == "bf16_rescue":
            # the JAX engine's refusals, with its texts
            if self.stat_mode == "fused" or config.gather_mode == "fused":
                raise ValueError(
                    "null_precision='bf16_rescue' screens the XLA chunk "
                    "composition; the fused Pallas paths (stat_mode/"
                    "gather_mode='fused') fold tallies in VMEM with no "
                    "screen point — use null_precision='auto' or 'f32'"
                )
            if self.row_sharded:
                raise ValueError(
                    "null_precision='bf16_rescue' is not taught the "
                    "row-sharded ring path; use matrix_sharding="
                    "'replicated' or null_precision='f32'"
                )
        #: max |test operand| of the screen's cushions (computed once)
        self._screen_amp = None
        #: the last screened run's RescueState (None before one)
        self.last_rescue = None
        #: whether the current run is screened (its cost family)
        self._screen_active = False
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
                take=self._take_positions(int(b["cap"]), b["module_pos"],
                                          b["slices"], dev),
            )
            for b in buckets
        ]
        #: every module's bucket; ``buckets`` is the active subset
        #: (:meth:`rebucket`)
        self._buckets_full = list(self.buckets)
        self._shards = None

    def _take_positions(self, cap, module_pos, slices, dev) -> torch.Tensor:
        """A bucket's ``take`` positions into the drawn permutations
        (:meth:`_draw`) padded with the zero column."""
        return _block_positions(cap, slices, self.pool.size, dev)

    def _draw(self, keys: trandom.ThreefryKey) -> torch.Tensor:
        """The permutations of a chunk's keys, ``(C, P)``: what ``take``
        indexes."""
        return trandom.permutation(keys, self._pool_dev)

    def _root_key(self, key) -> trandom.ThreefryKey:
        """A run's root key from the caller's ``key`` (:func:`root_key`)."""
        return root_key(key, self.device)

    def _props_mode(self) -> str:
        return props_mode(self.data_only, self.row_sharded, self.net_beta,
                          self.has_data)

    def _module_sig(self) -> str:
        """Content digest of the module specs (labels, index sets): the
        observed cache's key beside the fingerprint digest."""
        h = hashlib.blake2b(digest_size=8)
        for m in self.modules:
            h.update(str(m.label).encode() + b"|")
            h.update(np.ascontiguousarray(m.disc_idx, dtype=np.int64))
            h.update(np.ascontiguousarray(m.test_idx, dtype=np.int64))
        return h.hexdigest()

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
        """``(p, r, slice, engine view)`` per shard this process drives,
        in chunk order
        (:func:`~netrep_tpu_torch.parallel.sharded.chunk_shards`)."""
        if self._shards is None:
            placed: dict = {}
            self._shards = [
                (p, r, sl, self._on(p, r, placed))
                for p, r, sl in chunk_shards(
                    self.mesh, self.effective_chunk(),
                    self._stat_fused_ring())
                if self.mesh.is_local(p, r)
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

    def _shard_values(self, keys: trandom.ThreefryKey,
                      screened: bool = False) -> list:
        """Per shard, per-bucket null statistics of its slice of ``keys``,
        on its device: the ring path, or each perm shard's own body (on
        rounded operands when ``screened``)."""
        if self._stat_fused_ring():
            return self._ring_values(keys)
        return [
            eng._values(trandom.permutation(
                trandom.ThreefryKey(keys.words[sl]).to(eng.device),
                eng._pool_dev), screened)
            for _p, _r, sl, eng in self._shard_plan()
        ]

    # ------------------------------------------------------------------
    # Observed statistics
    # ------------------------------------------------------------------

    def observed(self) -> np.ndarray:
        """(n_modules, 7) observed statistics on the actual overlap sets,
        with the exact ``eigh`` summary (row-sharded: gathered from the
        row blocks, every bucket at once). With an observed cache, an
        engine of the same problem and modules computed them already: its
        copy (only at full strength, never after :meth:`rebucket`)."""
        cache, okey = self._observed_cache, None
        if (cache is not None and self._digest is not None
                and self.modules is not None
                and sum(len(b.module_pos) for b in self.buckets)
                == self.n_modules):
            okey = cache.observed_key(
                self._digest, self._module_sig(),
                f"{self._props_mode()}|g:{self.config.gather_mode}"
                f"|dt:{self.config.dtype}")
            hit = cache.get_observed(okey)
            if hit is not None:
                return hit
        out = np.full((self.n_modules, N_STATS), np.nan)
        subs = (zip(*self._gather([b.obs_idx for b in self.buckets]))
                if self.row_sharded else None)
        for b in self.buckets:
            res = self._observed_bucket(b, subs)
            out[b.module_pos] = res.cpu().numpy().astype(np.float64)
        if okey is not None:
            cache.put_observed(okey, out)
        return out

    def _observed_bucket(self, b: _Bucket, subs) -> torch.Tensor:
        """One bucket's ``(K, 7)`` observed statistics (``subs``: the
        row-sharded engine's gathered submatrices, one pair a bucket)."""
        if self.data_only:
            return data_only_gather_and_stats(
                b.disc, b.obs_idx, self._test_dataT, self.net_beta,
                n_iter=self.config.power_iters, summary_method="eigh")
        if self.row_sharded:
            return self._stats(b, b.obs_idx, *next(subs),
                               summary_method="eigh")
        return tstats.gather_and_stats(
            b.disc, b.obs_idx, self._test_corr, self._test_net,
            self._test_dataT, n_iter=self.config.power_iters,
            summary_method="eigh", net_beta=self.net_beta,
        )

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
               summary_method: str | None = None,
               dataT: torch.Tensor | None = None) -> torch.Tensor:
        """The composed statistics of one bucket from its gathered
        submatrices in the storage type, widened to float32 (``sub_n``
        None: derived from the widened ``sub_c``): the standardized data
        slice of ``dataT`` (default: the engine's), then
        ``module_stats_masked`` batched over (C, K) by broadcasting against
        the bucket's ``(K, …)`` discovery properties."""
        if sub_n is None:
            sub_n = tstats.derived_net(sub_c, self.net_beta)
        zd = (
            tstats.gather_zdata(
                self._test_dataT if dataT is None else dataT, idx,
                b.disc.mask)
            if self.has_data else None
        )
        return tstats.module_stats_masked(
            b.disc, sub_c, sub_n, zd, n_iter=self.config.power_iters,
            summary_method=summary_method or self.config.summary_method,
        )

    def _values(self, perm: torch.Tensor,
                screened: bool = False) -> list[torch.Tensor]:
        """Per-bucket ``(C, K, 7)`` null statistics of the drawn
        permutations ``perm`` ``(C, P)``: one fused-statistics launch per
        bucket, or the composed statistics — every bucket's submatrices
        gathered at once (one launch per matrix), then :meth:`_stats`
        bucket by bucket, each bucket's submatrices freed once used. In
        data-only mode each bucket's submatrices derive from its gathered
        data rows instead, and no kernel runs.

        ``screened``: the screened null's fast pass — the composed
        statistics of the gathered blocks and the data rounded through
        bfloat16 (:func:`~netrep_tpu_torch.parallel.screened.bf16_round`),
        float32 arithmetic on them."""
        idxs = [self._bucket_idx(perm, b) for b in self.buckets]
        td = self._test_dataT
        if screened and td is not None:
            td = scr.bf16_round(td)  # (n, samples): never an n x n copy
        if self.data_only:
            return [data_only_gather_and_stats(
                b.disc, idx, td, self.net_beta,
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
            sc, sn = subs_c[i], subs_n[i]
            if screened:
                sc, sn = scr.bf16_round(sc), scr.bf16_round(sn)
            outs.append(self._stats(b, idx, sc, sn, dataT=td))
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

    def _chunk(self, keys: trandom.ThreefryKey,
               screened: bool = False) -> list:
        """Per-bucket ``(C, K, 7)`` null statistics of a chunk's keys; on a
        mesh that spans processes, host arrays allgathered from every
        process's shards."""
        if self.mesh is None:
            return self._values(self._draw(keys), screened)
        shards = self._shard_values(keys, screened)
        outs = [torch.cat([s[i].to(self.device) for s in shards])
                for i in range(len(self.buckets))]
        if self.mesh.spans_processes:
            return distributed.gather_to_host(outs)
        return outs

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
        """``(count(keys, valid, acc), pull(acc), tallies)`` of the
        streaming null: ``count`` folds a chunk into the :class:`Tallies`
        ``acc`` and returns it, ``pull`` reads them to the host, and
        ``tallies`` are the run's, zeroed. On a mesh each shard keeps its
        own tallies on its device, gated by the validity mask offset by its
        slice's first column; ``pull`` sums them on the host."""
        if self.mesh is None:
            obs = self._obs_buckets(observed)

            def count(keys, valid, acc):
                self._count(self._draw(keys), valid, obs, acc.dev)
                return acc

            return (count, lambda acc: self._pull(acc.dev),
                    Tallies(self._zero_tallies()))

        plan = self._shard_plan()
        obs = [eng._obs_buckets(observed) for *_, eng in plan]
        ring = self._stat_fused_ring()

        def count(keys, valid, acc):
            vals = self._ring_values(keys) if ring else None
            for s, (_p, _r, sl, eng) in enumerate(plan):
                own = max(0, min(sl.stop, valid) - sl.start)
                if ring:
                    keep = torch.arange(sl.stop - sl.start,
                                        device=eng.device) < own
                    _add_tallies(acc.dev[s], count_buckets(vals[s], obs[s],
                                                           keep))
                else:
                    eng._count(trandom.permutation(
                        trandom.ThreefryKey(keys.words[sl]).to(eng.device),
                        eng._pool_dev), own, obs[s], acc.dev[s])
            return acc

        def pull(acc):
            parts = [eng._pull(t) for (*_, eng), t in zip(plan, acc.dev)]
            total = np.stack([sum(x) for x in zip(*parts)])
            if self.mesh.spans_processes:
                total = distributed.sum_to_host(total)
            return tuple(total)

        return count, pull, Tallies([eng._zero_tallies()
                                     for *_, eng in plan])

    # ------------------------------------------------------------------
    # The screened null (parallel/screened.py)
    # ------------------------------------------------------------------

    def _resolve_null_precision(self, observed) -> str:
        """``config.null_precision`` for one run: the screen runs only where
        the platform rule gives ``'bf16_rescue'``, on the composed
        statistics of replicated matrices, and against single-test
        ``(n_modules, 7)`` observed statistics; ``'auto'`` falls back to
        ``'f32'`` elsewhere, an explicit ask without ``observed`` raises
        the JAX package's error."""
        cfg = self.config
        if cfg.resolved_null_precision(self.device.type) != "bf16_rescue":
            return "f32"
        if (self.stat_mode == "fused" or cfg.gather_mode == "fused"
                or self.row_sharded):
            return "f32"
        if observed is None:
            if cfg.null_precision == "bf16_rescue":
                raise ValueError(
                    "null_precision='bf16_rescue' screens null statistics "
                    "against the observed values — pass observed= to "
                    "run_null (the adaptive/streaming entry points take "
                    "it already)"
                )
            return "f32"
        if np.asarray(observed).size != self.n_modules * N_STATS:
            return "f32"
        return "bf16_rescue"

    def _screen_amplitude(self) -> float:
        """max |test operand| (at least 1), the cushions' amplitude
        factor: one reduction per engine, cached."""
        if self._screen_amp is None:
            vals = [1.0]
            for a in (self._test_corr, self._test_net, self._test_dataT):
                if a is not None:
                    vals.append(float(a.abs().max()))
            self._screen_amp = max(vals)
        return self._screen_amp

    def _screened_obs_cush(self, observed) -> tuple[list, list]:
        """Per-bucket float32 ``(observed, cushion)`` tensors of the
        current buckets (the adaptive loops ask again after each
        re-bucketing)."""
        obs = np.asarray(observed, dtype=np.float64).reshape(
            self.n_modules, N_STATS)
        cush = scr.null_cushions(obs, self._screen_amplitude())
        return self._obs_buckets(obs), [
            torch.as_tensor(cush[b.module_pos], device=self.device)
            for b in self.buckets]

    def _screen_rescue(self, keys, idx: np.ndarray) -> list[np.ndarray]:
        """The float32 rows of the permutations at positions ``idx`` of the
        chunk ``keys``: the worklist padded to the chunk's length, so the
        rescue runs at the float32 run's batch shape and its rows are
        that run's bit for bit (the composed statistics of a row may round
        differently at another batch count); per bucket on the host. On a
        mesh that spans processes every process enters the rescue chunk's
        allgather, with the same worklist."""
        pad = scr.pad_worklist(idx, keys.shape[0])
        outs = self._chunk(scr.take_keys(keys, pad))
        return [_host(o)[: idx.size] for o in outs]

    def _screened_chunk(self, observed, state: scr.RescueState) -> Callable:
        """``chunk(keys)`` of the screened materialized and adaptive loops:
        the fast pass, the ambiguous worklist read on the host, its rows
        replaced by the float32 rescue. Returns per-bucket host arrays
        whose rescued rows are the float32 run's; the worklist read
        synchronises each chunk. On a mesh that spans processes the fast
        pass arrives allgathered, so every process reads the same
        worklist, rescues it through the same collective chunk and keeps
        the same ``state``."""

        def chunk(keys):
            obs_b, cush_b = self._screened_obs_cush(observed)
            outs = self._chunk(keys, screened=True)
            amb = scr.ambiguous_perms(
                [torch.as_tensor(o, device=self.device) for o in outs],
                obs_b, cush_b).cpu().numpy()
            outs = [_host(o) for o in outs]
            state.total += int(amb.size)
            idx = np.flatnonzero(amb)
            if idx.size:
                for o, r in zip(outs, self._screen_rescue(keys, idx)):
                    o[idx] = r
                state.rescued += int(idx.size)
                state.dispatches += 1
            return outs

        return chunk

    def _screen_pass(self, keys, valid: int, obs_b, cush_b, tallies):
        """The fast pass of one screened streaming chunk on this engine (or
        shard view): the decided comparisons of the first ``valid``
        permutations folded into the device ``tallies``. Returns the
        ambiguous mask, on the device."""
        outs = self._values(self._draw(keys), screened=True)
        keep = torch.arange(keys.shape[0], device=self.device) < valid
        amb = scr.ambiguous_perms(outs, obs_b, cush_b) & keep
        _add_tallies(tallies, count_buckets(outs, obs_b, keep & ~amb))
        return amb

    def _screened_stream_parts(self, observed, state: scr.RescueState):
        """``(count(keys, valid, acc), pull(acc), tallies)`` of the
        screened streaming nulls. ``count`` runs :meth:`_screen_pass` on
        the engine, or on a mesh on each shard this process drives (its
        slice of the keys, the validity mask offset by the slice's first
        column), then reads every shard's ambiguous mask at once; each
        shard rescues its own ambiguous rows, the worklist padded to its
        own batch length (the batch shape at which the float32 run on the
        same mesh computes these rows, so they are its rows bit for bit),
        and their exact host tallies (:func:`~netrep_tpu_torch.parallel.
        screened.host_tail_counts`) go to ``acc.host[0]``, the counters
        ``(total, rescued, dispatches)`` to ``acc.host[1]``: one dispatch
        per shard and chunk with a rescue. ``pull`` adds the device
        tallies and the rescued host tallies — on a mesh that spans
        processes summed over them, with the counters, in one
        :func:`~netrep_tpu_torch.parallel.distributed.sum_to_host` — so
        the tallies equal the float32 run's, and moves the counters
        gathered since the last pull into ``acc.state``: a pull is where
        the processes agree on them."""
        obs_full = np.asarray(observed, dtype=np.float64).reshape(
            self.n_modules, N_STATS)
        obs_b, cush_b = self._screened_obs_cush(observed)
        views = ([(None, self)] if self.mesh is None else
                 [(sl, eng) for _p, _r, sl, eng in self._shard_plan()])
        refs = [([o.to(eng.device) for o in obs_b],
                 [c.to(eng.device) for c in cush_b]) for _sl, eng in views]
        spans = self.mesh is not None and self.mesh.spans_processes

        def count(keys, valid, acc):
            passes = []
            for s, (sl, eng) in enumerate(views):
                if sl is None:
                    ks, own = keys, valid
                else:
                    ks = trandom.ThreefryKey(keys.words[sl]).to(eng.device)
                    own = max(0, min(sl.stop, valid) - sl.start)
                passes.append((eng, ks, eng._screen_pass(
                    ks, own, *refs[s], acc.dev[s])))
                acc.host[1][0] += own
            # every shard's fast pass is queued before the first read, and
            # every rescue before the first row read
            work = [(eng, ks, np.flatnonzero(amb.cpu().numpy()))
                    for eng, ks, amb in passes]
            rescues = [(eng, idx, eng._values(eng._draw(scr.take_keys(
                ks, scr.pad_worklist(idx, ks.shape[0])))))
                for eng, ks, idx in work if idx.size]
            for eng, idx, rows in rescues:
                for b, r in zip(eng.buckets, rows):
                    acc.host[0][:, b.module_pos] += np.stack(
                        scr.host_tail_counts(r[: idx.size].cpu().numpy(),
                                             obs_full[b.module_pos]))
                acc.host[1][1:] += (int(idx.size), 1)
            return acc

        def pull(acc):
            parts = [eng._pull(t) for (_sl, eng), t in zip(views, acc.dev)]
            tal = np.stack([sum(x) for x in zip(*parts)]) + acc.host[0]
            flat = np.concatenate([tal.ravel(), acc.host[1]])
            if spans:
                flat = distributed.sum_to_host(flat)
            acc.host[1][:] = 0
            got = flat[tal.size:]
            acc.state.total += int(got[0])
            acc.state.rescued += int(got[1])
            acc.state.dispatches += int(got[2])
            return tuple(flat[: tal.size].reshape(tal.shape))

        host = (np.zeros((3, self.n_modules, N_STATS), np.int64),
                np.zeros(3, np.int64))
        return count, pull, Tallies([eng._zero_tallies()
                                     for _sl, eng in views], host, state)

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
                nulls[at: at + take, b.module_pos] = _host(o[:take]).astype(
                    np.float64)

        return write

    def run_key(self) -> str:
        """The problem shape's key on ``compile_span`` events, in the JAX
        package's layout: card × statistics path × bucket caps × chunk.
        The path is ``data-only`` for a data-only engine (as the JAX key's
        mode), and a storage type other than float32 suffixes it
        (``fused+bfloat16``): each runs other kernels or instantiations,
        so its history never mixes with another's."""
        caps = ",".join(f"{b.cap}x{len(b.module_pos)}"
                        for b in self._buckets_full)
        card = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else self.device.type)
        mode = "data-only" if self.data_only else self.stat_mode
        if self.config.dtype != "float32":
            mode += f"+{self.config.dtype}"
        return (f"{card}|{mode}|caps:{caps}"
                f"|chunk:{int(self.effective_chunk())}")

    def autotune_key(self, extra: str = "") -> str:
        """The problem shape's key in the autotune store, in the JAX
        package's layout: backend (the card's name, or ``cpu``) × mode ×
        bucket caps × chunk × ``extra``. The mode is the JAX one:
        ``data-only``, else the gather mode (``'auto'`` as the JAX package
        resolves it on the CPU, ``direct``) with ``+fusedstats`` on the
        fused-statistics path, and ``+bf16rescue`` while a screened null
        runs, so screened and float32 histories never mix. A storage type
        other than float32 suffixes it as in :meth:`run_key`; the JAX key
        leaves the storage type out."""
        caps = ",".join(f"{b.cap}x{len(b.module_pos)}" for b in self.buckets)
        if self.data_only:
            mode = "data-only"
        else:
            gather = self.config.gather_mode
            mode = "direct" if gather == "auto" else gather
            if self.stat_mode == "fused":
                mode += "+fusedstats"
        if self.config.dtype != "float32":
            mode += f"+{self.config.dtype}"
        if self._screen_active:
            mode += "+bf16rescue"
        return autotune.make_key(autotune.backend_name(self.device), mode,
                                 caps, self.effective_chunk(), extra)

    def record_stream_throughput(self, perms_per_sec: float) -> None:
        """Keep a streaming run's steady rate for the ``(key,
        superchunk)`` it resolved (:func:`resolve_stream_superchunk`)."""
        rec = getattr(self, "_stream_autotune_record", None)
        if rec is not None:
            cache, key, k = rec
            cache.record(key, k, perms_per_sec)

    def _hooks(self, fault_policy, telemetry, profile=None) -> dict:
        """The loops' fault, telemetry and profile keywords of one run."""
        hooks = dict(fault_policy=fault_policy, telemetry=telemetry,
                     device=self.device, run_key=self.run_key(), engine=self,
                     mesh=self.mesh)
        if profile is not None:
            hooks["profile"] = profile
        return hooks

    def release(self) -> None:
        """Drop every device tensor the engine holds — the test operands,
        the pool, the buckets and the mesh's shard views — so that a
        rebuilt engine (the fault ladder's shrink, grow-back or CPU rung)
        never holds the card's memory beside this one. The engine is
        unusable afterwards."""
        self._test_corr = self._test_net = self._test_dataT = None
        self._rows_c = self._rows_n = self._gather_rep = None
        self._pool_dev = None
        self.buckets = []
        self._buckets_full = []
        self._shards = None

    def run_null(self, n_perm: int, key=0,
                 progress: Callable[[int, int], None] | None = None,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 8192, observed=None,
                 fault_policy=None, telemetry=None, profile=None,
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
        n_perm``.

        ``observed`` ``(n_modules, 7)``: the screened null's reference
        (``null_precision='bf16_rescue'`` needs it, and raises without
        it); the float32 path ignores it. A screened run's decided rows
        hold bf16-rounded values, its counts and p-values are the float32
        run's, and its :class:`~netrep_tpu_torch.parallel.screened.
        RescueState` is left in ``self.last_rescue``.

        ``fault_policy``, ``telemetry`` and ``profile``: the fault ladder,
        the event bus and the dispatch accounting of the loop
        (:func:`run_checkpointed_chunks`)."""
        key = self._root_key(key)
        state, fp = self._rescue_state(observed)
        chunk = (self._chunk if state is None
                 else self._screened_chunk(observed, state))
        return run_checkpointed_chunks(
            key, n_perm, self.effective_chunk(), chunk,
            self._null_write(), (n_perm, self.n_modules, N_STATS),
            progress, checkpointer(self, key, checkpoint_path,
                                   checkpoint_every, fp, state),
            full=self.mesh is not None,
            **self._hooks(fault_policy, telemetry, profile),
        )

    def _rescue_state(self, observed):
        """``(rescue_state, fingerprint_extra)`` of one run: ``(None,
        b"")`` for the float32 null, else a fresh
        :class:`~netrep_tpu_torch.parallel.screened.RescueState` (kept as
        ``self.last_rescue``) and the screened checkpoint suffix."""
        self._screen_active = (
            self._resolve_null_precision(observed) == "bf16_rescue")
        if not self._screen_active:
            return None, b""
        self.last_rescue = state = scr.RescueState()
        return state, scr.SCREEN_FP

    def _count_parts(self, observed, state):
        """``(count, pull, tallies)`` of a streaming null: float32
        (``state`` None) or screened."""
        if state is None:
            return self._stream_parts(observed)
        return self._screened_stream_parts(observed, state)

    def run_null_streaming(self, n_perm: int, observed: np.ndarray, key=0,
                           progress: Callable[[int, int], None] | None = None,
                           checkpoint_path: str | None = None,
                           checkpoint_every: int = 8192,
                           fault_policy=None, telemetry=None, profile=None,
                           ) -> StreamCounts:
        """The streaming permutation null: exceedance tallies against
        ``observed`` ``(n_modules, 7)``, accumulated on the device in int32
        over ``config.superchunk`` chunks between host reads (None:
        resolved from the autotune store, :func:`resolve_stream_superchunk`).
        For the same key the tallies equal ``tail_counts`` of
        :meth:`run_null`'s null. Checkpoints as :meth:`run_null`, saved at
        superchunk boundaries (:func:`run_stream_superchunks`); a
        materialized checkpoint is refused. ``fault_policy``,
        ``telemetry`` and ``profile`` as in :meth:`run_null`."""
        key = self._root_key(key)
        state, fp = self._rescue_state(observed)
        K = resolve_stream_superchunk(self, self.autotune_key("superchunk"))
        count, pull, tallies = self._count_parts(observed, state)
        (hi, lo, eff), completed = run_stream_superchunks(
            key, n_perm, self.effective_chunk(), K, count, pull, tallies,
            progress,
            checkpointer(self, key, checkpoint_path, checkpoint_every,
                         _STREAM_FP + fp, state),
            **self._hooks(fault_policy, telemetry, profile),
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
                          fault_policy=None, telemetry=None,
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
            checkpoint_every=checkpoint_every, fault_policy=fault_policy,
            telemetry=telemetry)

    def run_null_monitored(self, n_perm: int, key, monitor,
                           progress: Callable[[int, int], None] | None = None,
                           checkpoint_path: str | None = None,
                           checkpoint_every: int = 8192,
                           fault_policy=None, telemetry=None,
                           ) -> tuple[np.ndarray, int, bool]:
        """The materialized null under a caller's retirement monitor (the
        :class:`~netrep_tpu_torch.ops.sequential.StopMonitor` surface):
        after each chunk it folds the active modules' values and names the
        modules to retire, which :meth:`rebucket` drops from later chunks
        (:func:`run_adaptive_chunks`). The engine is left at full strength
        on exit."""
        key = self._root_key(key)

        def slice_vals(nulls, done, take, pos):
            return nulls[done: done + take][:, pos, :]

        # the screen reads the monitor's observed statistics when they are
        # the single-test (n_modules, 7) layout
        observed = getattr(monitor, "observed", None)
        state, fp = self._rescue_state(observed)
        chunk = (self._chunk if state is None
                 else self._screened_chunk(observed, state))
        try:
            return run_adaptive_chunks(
                key, n_perm, self.effective_chunk(), chunk,
                self._null_write(), (n_perm, self.n_modules, N_STATS),
                slice_vals, monitor, self.rebucket, progress,
                checkpointer(self, key, checkpoint_path, checkpoint_every,
                             fp, state),
                full=self.mesh is not None,
                **self._hooks(fault_policy, telemetry),
            )
        finally:
            if self._buckets_full:
                self.rebucket(range(self.n_modules))

    def run_null_adaptive_streaming(
            self, n_perm: int, observed: np.ndarray, key=0,
            alternative: str = "greater", rule=None,
            progress: Callable[[int, int], None] | None = None,
            checkpoint_path: str | None = None, checkpoint_every: int = 8192,
            fault_policy=None, telemetry=None, profile=None,
    ) -> StreamCounts:
        """Streaming variant of :meth:`run_null_adaptive`: one chunk per
        dispatch, the monitor folding the kernel's tallies
        (:func:`run_adaptive_stream_chunks`), so retirement equals the
        materialized adaptive run's at the same key. Returns a
        :class:`StreamCounts` with per-module ``n_perm_used`` and the
        ``finished`` flag."""
        monitor = self._monitor(observed, alternative, rule)
        key = self._root_key(key)
        state, fp = self._rescue_state(observed)
        try:
            completed, finished = run_adaptive_stream_chunks(
                key, n_perm, self.effective_chunk(),
                chunk_counts(lambda: self._count_parts(observed, state),
                             monitor, lambda a, pos: a[pos]), monitor,
                self.rebucket, progress,
                checkpointer(self, key, checkpoint_path, checkpoint_every,
                             _STREAM_FP + fp, state),
                **self._hooks(fault_policy, telemetry, profile),
            )
        finally:
            if self._buckets_full:
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


def _host(o) -> np.ndarray:
    """A chunk output as a host array: a tensor copied to the host, an
    allgathered host array as it is."""
    return o.cpu().numpy() if isinstance(o, torch.Tensor) else o


def _add_tallies(tallies, deltas) -> None:
    """Fold per-bucket ``(hi, lo, eff)`` deltas into ``tallies`` in
    place."""
    for acc, d in zip(tallies, deltas):
        for t, x in zip(acc, d):
            t += x
