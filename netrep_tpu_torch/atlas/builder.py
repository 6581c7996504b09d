"""Streaming construction pass over the tile grid, with exact tile
screening.

The port of ``netrep_tpu/atlas/builder.py``. One scan of the tile grid of a
:class:`~netrep_tpu_torch.atlas.tiles.TiledNetwork` produces, without ever
forming ``n × n``:

- **thresholded edges**: per-row top-k (selected on the device, ``O(edge·k)``
  sent to the host) or ``|r| ≥ τ`` (selected on the device, only the
  survivors sent), in :class:`~netrep_tpu_torch.ops.sparse.SparseAdjacency`
  form, symmetrized by union: the input of the Config E engine
  (:func:`~netrep_tpu_torch.models.sparse_api.sparse_module_preservation`);
- **per-node degrees** over the whole derived network (``degree=``), on an
  unscreened pass only: the degree is a sum over every tile.

**Exact tile screening** (``screen=True``) skips tiles that provably hold
no edge of the output: per-column sample-segment norms bound every
correlation of a tile (:meth:`TiledNetwork.column_moments`,
:func:`~netrep_tpu_torch.atlas.tiles.tile_norm_maxima`); super-tiles of
``supertile`` tiles are judged first, surviving groups refine to tiles,
and a tile is skipped when its bound plus a float32 margin falls below the
τ cut or the running per-row top-k floor. The screened pass emits the
unscreened pass's edges bit for bit, because every tile's ``r`` is the same
in both: each row block's tiles go through one call shape, a batched
product of ``TILE_BATCH`` tiles of ``(edge, s) × (s, edge)`` (padding tiles
masked), whether they come from the full strip or from a worklist. A BLAS
library picks its algorithm, and with it the summation order, by the
call's shapes; with one shape it picks one. Everything after the products
is elementwise or a selection, and the folds across tiles run on the host
in float64.

What differs from the JAX package, and why:

- **Top-k with its tie rule.** ``lax.top_k`` orders by value descending,
  ties by ascending index; ``torch.topk`` promises nothing about ties.
  Here top-k runs on a unique int64 key per entry, the score's float32
  bits (monotone: the score is ``|r| ≥ 0`` or ``-1``) above
  ``2³²-1 - column``, which is that order exactly.
- **τ survivors by ``torch.nonzero``**, whose row-major order is the
  host's ``np.nonzero`` order; the JAX package's fixed-capacity compaction
  and its grow-and-retry loop exist for XLA's static shapes and are gone.
- **The mesh** (:func:`~netrep_tpu_torch.parallel.mesh.make_mesh`) splits
  each pass's product calls over the devices of its ``perm`` axis; every
  device runs the same call shape, the strip is assembled on the first
  device, so a split pass equals an unsplit one bit for bit.
- **Tile edge and super-tile factor** take the JAX package's static
  defaults (:data:`DEFAULT_TILE_EDGE`, :data:`DEFAULT_SUPERTILE`); its
  measured store is ROADMAP.md Queue 1 item 16a, as are the pass's
  telemetry spans and the fault ladder.

Checkpoint/resume, the ``x_atlas_*`` extras, the fingerprint (which leaves
the screening knobs out, so a checkpoint resumes across a screening toggle)
and the failure-save are the JAX package's, format and all: an interrupted
JAX build resumes here.

TF32 stays off (``netrep_tpu_torch.utils``, imported first): with a 10-bit
operand mantissa :func:`_bound_margin` would no longer cover the rounding of
a skipped tile, and screening would stop being exact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import utils  # noqa: F401  (pins full-float32 matrix products)
from ..ops import stats as tstats
from ..ops.sparse import SparseAdjacency
from ..parallel import mesh as tmesh
from ..utils.checkpoint import (
    load_null_checkpoint, save_null_checkpoint, validate_identity,
)
from ..utils.config import EngineConfig
from .tiles import (
    TiledNetwork, derived_net_np, supertile_maxima, tile_norm_maxima,
)

#: static tile edge and super-tile factor, the JAX package's defaults
#: (``netrep_tpu/utils/autotune.py`` ``DEFAULT_TILE_EDGE``,
#: ``DEFAULT_SUPERTILE``): a 1024-row block keeps one block's strip near
#: 0.4 GB at 100,000 genes; the measured store that would replace them is
#: ROADMAP.md Queue 1 item 16a
DEFAULT_TILE_EDGE = 1024
DEFAULT_SUPERTILE = 8

#: tiles per product call: every tile of a pass, strip or worklist, goes
#: through a batched product of this many tiles, so its ``r`` never
#: depends on how the pass dispatched it
TILE_BATCH = 4


@dataclasses.dataclass
class AtlasBuild:
    """Result of one construction pass.

    ``adjacency`` carries the derived-net weights at the selected edges,
    ``correlation`` the raw r values on the same neighbour structure;
    ``degree`` is the full (unthresholded) derived-net weighted degree per
    node, or None when the pass ran with ``degree=False`` (always under
    screening). ``tiles_*`` and ``strip_bytes_*`` tally the screen and the
    device-to-host transfers."""

    adjacency: SparseAdjacency
    correlation: SparseAdjacency
    degree: np.ndarray | None
    n: int
    tile_edge: int
    n_blocks: int
    selected_edges: int            # directed selections before symmetrize
    supertile: int = 0             # coarse group factor (0 = unscreened)
    tiles_total: int = 0           # real tiles in the scanned grid
    tiles_dispatched: int = 0
    tiles_skipped: int = 0
    strip_bytes_full: int = 0      # what full-strip transfers would move
    strip_bytes_moved: int = 0     # what actually crossed to the host


def _fingerprint(net: TiledNetwork, edge: int, top_k, tau,
                 degree: bool) -> np.ndarray:
    """Checkpoint identity of one pass, the JAX package's string. It
    leaves out the screening knobs (``screen``/``supertile``/
    ``screen_segments``) on purpose: screened and unscreened passes give
    the same output, so a checkpoint written by either resumes under the
    other. The threshold rule, tile edge and degree flag change the
    output, so they refuse."""
    spec = (
        f"atlas-pass|{net.spec_digest()}|n:{net.n}|edge:{int(edge)}"
        f"|topk:{top_k}|tau:{tau}|deg:{int(bool(degree))}"
    )
    return np.frombuffer(spec.encode(), dtype=np.uint8)


#: the pass draws no random numbers; the checkpoint key slot carries this
#: constant so the shared identity check's seed test always passes
_KEY_DATA = np.zeros(2, dtype=np.uint32)

#: column sentinel for empty top-k candidate slots: sorts after every real
#: column, so ties against real candidates are never affected
_COL_SENTINEL = np.int64(1) << 62

_LOW32 = (1 << 32) - 1


def _bound_margin(s: int) -> float:
    """Margin added to every screening bound before it is compared with a
    threshold: the bounds hold for the real-valued correlations, the
    device computes ``r`` in float32, and a length-``s`` float32 dot
    product of unit vectors errs by at most ~s·2⁻²⁴; 16× that plus an
    absolute floor keeps even the rounded |r| of a skipped tile below the
    threshold."""
    return 16.0 * s * 2.0 ** -24 + 1e-7


def _bucket_width(n_work: int, ax: int) -> int:
    """Worklist width for ``n_work`` surviving tiles: the next power of
    two (few distinct top-k widths), rounded up to a multiple of the mesh
    axis."""
    w = 1
    while w < n_work:
        w <<= 1
    if ax > 1:
        w = -(-w // ax) * ax
    return w


def _tau_ceil32(tau: float) -> np.float32:
    """Smallest float32 ≥ τ. Comparing a float32 |r| with it is the float64
    comparison ``|r| ≥ τ`` exactly, knife-edge values included."""
    t = np.float32(tau)
    if float(t) < tau:
        t = np.nextafter(t, np.float32(np.inf), dtype=np.float32)
    return t


def _merge_topk(cv, cc, cr, nv, nc, nr, k: int):
    """Fold one group's per-row candidates into the running per-row top-k.
    Two stable sorts (columns ascending, then score descending) give
    ``lax.top_k``'s order (value descending, ties by ascending column), so
    the merged sequence is what one full-strip top-k would give."""
    v = np.concatenate([cv, nv], axis=1)
    c = np.concatenate([cc, nc], axis=1)
    r = np.concatenate([cr, nr], axis=1)
    o1 = np.argsort(c, axis=1, kind="stable")
    v = np.take_along_axis(v, o1, axis=1)
    c = np.take_along_axis(c, o1, axis=1)
    r = np.take_along_axis(r, o1, axis=1)
    o2 = np.argsort(-v, axis=1, kind="stable")
    return (
        np.take_along_axis(v, o2, axis=1)[:, :k],
        np.take_along_axis(c, o2, axis=1)[:, :k],
        np.take_along_axis(r, o2, axis=1)[:, :k],
    )


class _Tiles:
    """The device side of one pass: the standardized columns, padded to a
    whole number of product calls and replicated on each device of the
    split, and the per-tile program every dispatch runs."""

    def __init__(self, z: np.ndarray, edge: int, n: int, beta,
                 devices: list[torch.device]):
        self.edge, self.n, self.beta = edge, n, beta
        T = -(-z.shape[0] // edge)
        self.T = -(-T // TILE_BATCH) * TILE_BATCH
        pad = self.T * edge - z.shape[0]
        if pad:
            z = np.concatenate([z, np.zeros((pad, z.shape[1]), np.float32)])
        self.devices = devices
        self.main = devices[0]
        self.z = {}
        for dev in devices:
            if dev not in self.z:
                self.z[dev] = torch.as_tensor(z).to(dev).view(
                    self.T, edge, z.shape[1])

    def strip(self, row0: int, tids: np.ndarray):
        """``(r, score, mask)`` of the row block at ``row0`` against the
        tiles ``tids`` (int64, ``-1`` for padding, a multiple of
        ``TILE_BATCH`` long): ``(edge, len(tids)·edge)`` strips in tile
        order on the first device — r clipped to [-1, 1], the valid pairs
        (real tile, row and column, not self), and the score, ``|r|`` at
        valid pairs and ``-1`` elsewhere."""
        edge, s = self.edge, self.z[self.main].shape[-1]
        W = tids.size
        r = torch.empty((edge, W, edge), dtype=torch.float32,
                        device=self.main)
        calls = W // TILE_BATCH
        for c in range(calls):
            # the calls split over the devices in contiguous runs, as a
            # shard_map splits an axis
            dev = self.devices[c * len(self.devices) // calls]
            zt = self.z[dev]
            ids = torch.as_tensor(
                np.maximum(tids[c * TILE_BATCH:(c + 1) * TILE_BATCH], 0),
                device=dev)
            zI = zt.view(-1, s)[row0: row0 + edge]
            rb = torch.bmm(zI.expand(TILE_BATCH, edge, s),
                           zt.index_select(0, ids).transpose(1, 2))
            rb.clamp_(-1.0, 1.0)
            r[:, c * TILE_BATCH:(c + 1) * TILE_BATCH] = \
                rb.to(self.main).transpose(0, 1)
        r = r.view(edge, W * edge)
        tid = torch.as_tensor(tids, device=self.main)
        ar = torch.arange(edge, device=self.main)
        cols = (tid[:, None] * edge + ar).reshape(-1)
        rows = row0 + ar
        mask = ((tid >= 0).repeat_interleave(edge)[None, :]
                & (cols < self.n)[None, :] & (rows < self.n)[:, None]
                & (cols[None, :] != rows[:, None]))
        score = torch.where(mask, r.abs(), -1.0)
        return r, score, mask

    def degree_parts(self, r, mask, n_tiles: int) -> np.ndarray:
        """``(n_tiles, edge)`` float32 per-tile row sums of the derived
        network at valid pairs (the cross-tile fold is the host's)."""
        net = torch.where(mask, tstats.derived_net(r, self.beta), 0.0)
        parts = net.view(self.edge, -1, self.edge).sum(-1)
        return parts[:, :n_tiles].T.contiguous().cpu().numpy()


def _topk(r, score, k: int):
    """Per-row top-``k`` of a strip in ``lax.top_k``'s order (value
    descending, ties by ascending position), on a unique int64 key: the
    score's float32 bits above ``2³²-1 - position``. Returns host arrays
    ``(positions int32, r, score)``, each ``(edge, k)``."""
    key = score.view(torch.int32).to(torch.int64)
    key.bitwise_left_shift_(32)
    key += _LOW32 - torch.arange(score.shape[1], device=score.device)
    idx = torch.topk(key, k, dim=1).indices
    del key
    return (idx.to(torch.int32).cpu().numpy(),
            torch.gather(r, 1, idx).cpu().numpy(),
            torch.gather(score, 1, idx).cpu().numpy())


def _tau_select(r, score, tau32):
    """Survivors ``score ≥ τ`` of a strip in row-major order, as host
    arrays ``(row, position)`` int32 and r float32."""
    sel = score >= float(tau32)
    nz = torch.nonzero(sel).to(torch.int32).cpu().numpy()
    return nz[:, 0], nz[:, 1], r[sel].cpu().numpy()


def _not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name}= is not ported yet: ROADMAP.md Queue 1 item 16 "
        "(device-touching utils and CLI)"
    )


def build_sparse_network(
    net: TiledNetwork,
    top_k: int | None = None,
    tau: float | None = None,
    *,
    tile_edge: int | None = None,
    config: EngineConfig | None = None,
    mesh=None,
    screen: bool = False,
    supertile: int | None = None,
    screen_segments: int = 8,
    degree: bool | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    progress: Callable[[int, int], None] | None = None,
    telemetry=None,
    fault_policy=None,
    _screen_observer: Callable | None = None,
    device=None,
) -> AtlasBuild:
    """One streaming scan of the tile grid (module docstring). Exactly one
    of ``top_k`` (per-row strongest |r| edges) / ``tau`` (``|r| ≥ τ``,
    τ > 0) picks the threshold rule.

    ``screen=True`` dispatches only tiles whose moment bound clears the
    active threshold (τ, or the running per-row top-k floor); the output
    equals ``screen=False``'s bit for bit. Screening requires
    ``degree=False``; ``degree`` defaults to ``not screen``. ``tile_edge``
    and ``supertile`` default to :data:`DEFAULT_TILE_EDGE` and
    :data:`DEFAULT_SUPERTILE`; ``screen_segments`` is the number of sample
    segments the bounds use (any value is exact). ``checkpoint_every``
    counts row blocks; an interrupted pass resumes from
    ``checkpoint_path``, across a screening toggle too. ``mesh`` splits
    the product calls over its ``perm`` axis. ``device`` (None: the card;
    the CPU only when named) is where the pass runs, or with a mesh, the
    kind of device the mesh is on. ``telemetry`` and ``fault_policy`` are
    not ported yet (ROADMAP.md Queue 1 item 16).

    ``_screen_observer(block, level, tile_ids, threshold)`` is a test hook:
    called on every skip decision with the tiles skipped and the threshold
    they were judged against.
    """
    if telemetry is not None:
        raise _not_ported("telemetry")
    if fault_policy is not None:
        raise _not_ported("fault_policy")
    if (top_k is None) == (tau is None):
        raise ValueError("pass exactly one of top_k (int) or tau (float)")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if tau is not None and not tau > 0:
        raise ValueError(
            f"tau must be > 0 (τ=0 would keep every pair — the dense "
            f"matrix the tile plane exists to avoid), got {tau}"
        )
    if degree is None:
        degree = not screen
    with_deg = bool(degree)
    if screen and with_deg:
        raise ValueError(
            "screen=True cannot compute the full-network degree vector — "
            "the degree is a sum over every tile, including the ones "
            "screening skips; pass degree=False (the screened default) "
            "or screen=False"
        )
    config = config or EngineConfig()
    dev = tmesh.resolve_device(mesh, device)
    n, s = net.n, net.n_samples
    mode = "topk" if top_k is not None else "tau"

    edge = max(8, int(tile_edge)) if tile_edge is not None \
        else DEFAULT_TILE_EDGE
    edge = int(min(edge, max(8, -(-n // 8) * 8)))
    ax, devices = 1, [dev]
    if mesh is not None:
        ax = mesh.shape[config.mesh_axis]
        devices = [mesh.devices[p, 0] for p in range(ax)]
    B = -(-n // edge)                      # row blocks (real rows only)
    T_real = -(-n // edge)                 # real column tiles
    k_eff = None if top_k is None else int(min(top_k, max(1, n - 1)))
    tau32 = None if tau is None else _tau_ceil32(tau)
    tau_cmp = None if tau32 is None else float(tau32)

    # two-resolution screening tables (host float64, deterministic)
    S_res = 0
    M = MS = SB = None
    margin = _bound_margin(s)
    if screen:
        S_res = max(1, int(supertile)) if supertile is not None \
            else DEFAULT_SUPERTILE
        S_res = int(max(1, min(S_res, T_real)))
        A = net.column_moments(screen_segments)
        M = tile_norm_maxima(A, edge, T_real)
        MS = supertile_maxima(M, S_res)
        if mode == "tau":
            # super-row × super-col bound grid: one table prunes whole
            # S×S blocks of the tile grid
            SB = np.minimum(MS @ MS.T, 1.0)

    # accumulators (+ resume)
    deg = np.zeros(n, dtype=np.float64)
    rows_l: list[np.ndarray] = []
    cols_l: list[np.ndarray] = []
    corr_l: list[np.ndarray] = []
    start_block = 0
    tally = dict(atlas_tiles_dispatched=0, atlas_tiles_skipped=0,
                 atlas_bytes_full=0, atlas_bytes_moved=0)
    fp = _fingerprint(net, edge, k_eff, tau, with_deg)
    if checkpoint_path is not None:
        ckpt = load_null_checkpoint(checkpoint_path)
        if ckpt is not None:
            validate_identity(ckpt, _KEY_DATA, fp, checkpoint_path)
            deg = np.asarray(ckpt["nulls"], dtype=np.float64).copy()
            start_block = int(ckpt["completed"])
            ex = ckpt["extras"]
            if ex.get("atlas_rows") is not None and ex["atlas_rows"].size:
                rows_l = [ex["atlas_rows"].astype(np.int64)]
                cols_l = [ex["atlas_cols"].astype(np.int64)]
                corr_l = [ex["atlas_corr"].astype(np.float64)]
            # the screening and transfer tally: exact across interrupts,
            # and starting at zero across a screening toggle's missing one
            for name in tally:
                if ex.get(name) is not None:
                    tally[name] = int(np.asarray(ex[name]).reshape(-1)[0])

    def save(done: int) -> None:
        if checkpoint_path is None:
            return
        cat = {
            "atlas_rows": (rows_l, np.int64), "atlas_cols": (cols_l, np.int64),
            "atlas_corr": (corr_l, np.float64),
        }
        save_null_checkpoint(
            checkpoint_path, deg, done, _KEY_DATA, fp,
            extra={
                **{k: np.concatenate(parts) if parts else np.empty(0, dt)
                   for k, (parts, dt) in cat.items()},
                **{k: np.int64(v) for k, v in tally.items()},
            },
        )

    tiles = _Tiles(net.z32(), edge, n, net.beta, devices)
    all_tiles = np.arange(tiles.T, dtype=np.int64)

    def padded(ids, w):
        """``ids`` padded with -1 to ``w`` rounded up to whole calls."""
        out = np.full(-(-w // TILE_BATCH) * TILE_BATCH, -1, np.int64)
        out[:ids.size] = ids
        return out

    def decode(pos, wids):
        """Strip positions to global columns (padding slots negative)."""
        pos = pos.astype(np.int64)
        return wids[pos // edge] * edge + pos % edge

    done = start_block
    last_saved = start_block
    try:
        for b in range(start_block, B):
            row0 = b * edge
            lo = row0
            hi = min(row0 + edge, n)
            m = hi - lo
            disp_b = 0
            skip_b = 0
            moved_b = 0

            if not screen:
                # ---- unscreened: the full strip -------------------------
                r, score, mask = tiles.strip(row0, all_tiles)
                if with_deg:
                    deg_b = tiles.degree_parts(r, mask, T_real)
                    moved_b += deg_b.nbytes
                    # cross-tile fold on the host in float64, in tile
                    # order, however the calls were split
                    deg[lo:hi] += deg_b.astype(np.float64).sum(axis=0)[:m]
                if k_eff is not None:
                    idxs, r_sel, vals = _topk(r, score, k_eff)
                    moved_b += idxs.nbytes + r_sel.nbytes + vals.nbytes
                    keep = vals[:m] >= 0   # rows short of k candidates
                    ii, _jj = np.nonzero(keep)
                    rows_l.append((lo + ii).astype(np.int64))
                    cols_l.append(idxs[:m][keep].astype(np.int64))
                    corr_l.append(r_sel[:m][keep].astype(np.float64))
                else:
                    ii, jj, rv = _tau_select(r, score, tau32)
                    moved_b += ii.nbytes + jj.nbytes + rv.nbytes
                    rows_l.append(lo + ii.astype(np.int64))
                    cols_l.append(jj.astype(np.int64))
                    corr_l.append(rv.astype(np.float64))
                del r, score, mask
                disp_b = T_real
            else:
                # ---- screened: coarse → refine → worklist dispatch ------
                mb = M[b]                          # row-block max norms
                cb = np.minimum(MS @ mb, 1.0)      # coarse (per group)
                G = MS.shape[0]
                if k_eff is not None:
                    cand_v = np.full((m, k_eff), -1.0, np.float32)
                    cand_c = np.full((m, k_eff), _COL_SENTINEL, np.int64)
                    cand_r = np.zeros((m, k_eff), np.float32)
                    floor = -1.0
                    # descending-bound order: signal groups first, so the
                    # per-row floors tighten before noise groups are judged
                    order = np.argsort(-cb, kind="stable")
                    for g in order:
                        t0g = int(g) * S_res
                        t1g = min(t0g + S_res, T_real)
                        n_g = t1g - t0g
                        if cb[g] + margin < floor:
                            skip_b += n_g
                            if _screen_observer is not None:
                                _screen_observer(
                                    b, "coarse",
                                    np.arange(t0g, t1g, dtype=np.int64),
                                    float(floor),
                                )
                            continue
                        tb = np.minimum(M[t0g:t1g] @ mb, 1.0)
                        live = (tb + margin) >= floor
                        if not live.all():
                            dropped = t0g + np.flatnonzero(~live)
                            skip_b += int(dropped.size)
                            if _screen_observer is not None:
                                _screen_observer(b, "refine", dropped,
                                                 float(floor))
                        # pending tiles of this group, strongest bound
                        # first: while no floor exists yet, dispatch only
                        # a bootstrap batch (just enough tiles to fill k
                        # candidates per row), so the floor forms before
                        # the bulk of the group is committed
                        o = np.argsort(-tb[live], kind="stable")
                        pending = (t0g + np.flatnonzero(live))[o]
                        pbound = tb[live][o]
                        boot = max(1, -(-2 * k_eff // edge))
                        while pending.size:
                            if floor < 0:
                                take = pending[:boot]
                                pending = pending[boot:]
                                pbound = pbound[boot:]
                            else:
                                ok = (pbound + margin) >= floor
                                if not ok.all():
                                    dropped = pending[~ok]
                                    skip_b += int(dropped.size)
                                    if _screen_observer is not None:
                                        _screen_observer(
                                            b, "refine", np.sort(dropped),
                                            float(floor),
                                        )
                                take = pending[ok]
                                pending = pending[:0]
                                if take.size == 0:
                                    break
                            # ascending within the dispatch: the group's
                            # top-k tie order (by worklist position) must
                            # be the global column order
                            take = np.sort(take)
                            w = _bucket_width(take.size, ax)
                            wids = padded(take, w)
                            r, score, _mask = tiles.strip(row0, wids)
                            idxs, r_sel, vals = _topk(
                                r, score, int(min(k_eff, w * edge)))
                            del r, score, _mask
                            moved_b += (idxs.nbytes + r_sel.nbytes
                                        + vals.nbytes)
                            vals = vals[:m]
                            r_sel = r_sel[:m]
                            cols = decode(idxs[:m], wids)
                            bad = vals < 0
                            cols[bad] = _COL_SENTINEL
                            r_sel = np.where(bad, np.float32(0.0), r_sel)
                            cand_v, cand_c, cand_r = _merge_topk(
                                cand_v, cand_c, cand_r, vals, cols, r_sel,
                                k_eff,
                            )
                            # the running floor: weakest k-th-best across
                            # the block's rows (-1 until every row holds k
                            # real candidates — no skipping before that)
                            floor = float(cand_v[:, -1].min())
                            disp_b += int(take.size)
                    keep = cand_v >= 0
                    ii, _jj = np.nonzero(keep)
                    rows_l.append((lo + ii).astype(np.int64))
                    cols_l.append(cand_c[keep])
                    corr_l.append(cand_r[keep].astype(np.float64))
                else:
                    gr = b // S_res                # row super-group
                    parts_r: list[np.ndarray] = []
                    parts_c: list[np.ndarray] = []
                    parts_v: list[np.ndarray] = []
                    for g in range(G):
                        t0g = g * S_res
                        t1g = min(t0g + S_res, T_real)
                        n_g = t1g - t0g
                        # S×S coarse level: the super-row × super-col
                        # bound prunes this whole group for every block
                        # in the row group from one precomputed table
                        if (SB[gr, g] + margin < tau_cmp
                                or cb[g] + margin < tau_cmp):
                            skip_b += n_g
                            if _screen_observer is not None:
                                _screen_observer(
                                    b, "coarse",
                                    np.arange(t0g, t1g, dtype=np.int64),
                                    tau_cmp,
                                )
                            continue
                        tb = np.minimum(M[t0g:t1g] @ mb, 1.0)
                        live = (tb + margin) >= tau_cmp
                        work = t0g + np.flatnonzero(live)
                        if work.size < n_g:
                            dropped = t0g + np.flatnonzero(~live)
                            skip_b += int(dropped.size)
                            if _screen_observer is not None:
                                _screen_observer(b, "refine", dropped,
                                                 tau_cmp)
                        if work.size == 0:
                            continue
                        wids = padded(work, _bucket_width(work.size, ax))
                        r, score, _mask = tiles.strip(row0, wids)
                        ii, pos, rv = _tau_select(r, score, tau32)
                        del r, score, _mask
                        moved_b += ii.nbytes + pos.nbytes + rv.nbytes
                        parts_r.append(lo + ii.astype(np.int64))
                        parts_c.append(decode(pos, wids))
                        parts_v.append(rv.astype(np.float64))
                        disp_b += int(work.size)
                    if parts_r:
                        br = np.concatenate(parts_r)
                        bc = np.concatenate(parts_c)
                        bv = np.concatenate(parts_v)
                        # groups dispatched out of column order reassemble
                        # into the unscreened (row-major) emit order
                        o = np.lexsort((bc, br))
                        rows_l.append(br[o])
                        cols_l.append(bc[o])
                        corr_l.append(bv[o])

            tally["atlas_tiles_dispatched"] += disp_b
            tally["atlas_tiles_skipped"] += skip_b
            tally["atlas_bytes_full"] += m * T_real * edge * 4
            tally["atlas_bytes_moved"] += moved_b
            done = b + 1
            if progress is not None:
                progress(done, B)
            if (checkpoint_path is not None
                    and done - last_saved >= checkpoint_every):
                save(done)
                last_saved = done
    except BaseException:
        # failure-save (KeyboardInterrupt included): completed row blocks
        # are never scanned again
        if done > last_saved:
            save(done)
        raise
    if checkpoint_path is not None and done > last_saved:
        save(done)

    rows = np.concatenate(rows_l) if rows_l else np.empty(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.empty(0, np.int64)
    corr = np.concatenate(corr_l) if corr_l else np.empty(0, np.float64)
    wgt = derived_net_np(corr, net.beta)
    adjacency = SparseAdjacency.from_coo(rows, cols, wgt, n, symmetrize=True)
    correlation = SparseAdjacency.from_coo(
        rows, cols, corr, n, symmetrize=True
    )
    return AtlasBuild(
        adjacency=adjacency, correlation=correlation,
        degree=deg if with_deg else None, n=n,
        tile_edge=edge, n_blocks=B, selected_edges=int(rows.size),
        supertile=int(S_res), tiles_total=int(B * T_real),
        tiles_dispatched=tally["atlas_tiles_dispatched"],
        tiles_skipped=tally["atlas_tiles_skipped"],
        strip_bytes_full=tally["atlas_bytes_full"],
        strip_bytes_moved=tally["atlas_bytes_moved"],
    )
