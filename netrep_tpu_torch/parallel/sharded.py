"""Row-sharded n×n matrices and their module gathers, in one process.

The port of ``netrep_tpu/parallel/sharded.py``. A matrix split by rows over
a mesh's ``row`` axis is held as ``blocks[p][r]``: the ``(rows_per, n)``
block of global rows ``[r * rows_per, (r + 1) * rows_per)`` on device
``mesh.devices[p, r]`` (full row width, so the column gather is local).
Perm shards that share a device share its blocks; on a mesh over one
device every block is a view of one tensor (:func:`shard_rows`).

A module gather ``M[idx][:, idx]`` from such a matrix is assembled from the
row blocks, the JAX package's ``psum`` over the row axis. Where the blocks
lie on the perm shard's device, each block's launch of the gather kernel
(:func:`~netrep_tpu_torch.ops.fused_gather.gather_submatrix_fused_many`
with ``out=``) writes the rows it owns, for every bucket at once, into one
set of buffers: each entry is written once, so the assembly is exact and
nothing is summed. A block on another card gives its share there (the
rows it does not own are zero), which is copied over and added: each
entry still receives one nonzero share. The other assembly, the ring, is
:func:`netrep_tpu_torch.ops.fused_stats.ring_gather_all`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import stats as tstats
from ..ops.fused_gather import gather_submatrix_fused_many
from .mesh import PERM_AXIS, ROW_AXIS, Mesh


def pad_square_to_multiple(mat: torch.Tensor, d: int) -> torch.Tensor:
    """Zero-pad both axes of a square matrix to a multiple of ``d`` (the
    padding is inert: gather indices only ever point at real nodes, and the
    local gather never reads a row or column at or past the padded width).
    Returns ``mat`` itself when nothing is to pad."""
    pad = (-mat.shape[0]) % d
    if pad == 0:
        return mat
    return F.pad(mat, (0, pad, 0, pad))


def shard_rows(mat: torch.Tensor, mesh: Mesh,
               axis: str = ROW_AXIS) -> list[list[torch.Tensor]]:
    """Split an ``(n, n)`` matrix by rows over ``axis``: ``blocks[p][r]``
    on ``mesh.devices[p, r]``. Rows must divide evenly by the axis size
    (pad first: :func:`pad_square_to_multiple`). Where every device of the
    mesh is ``mat``'s, the blocks are views of ``mat`` (of a contiguous
    copy, if ``mat`` is laid out otherwise: the kernels read rows) and
    nothing else is copied; otherwise each block is a copy of its own, so
    ``mat`` can be freed."""
    mat = mat.contiguous()
    n = mat.shape[0]
    d = mesh.shape[axis]
    if n % d:
        raise ValueError(
            f"rows ({n}) not divisible by mesh axis {axis!r} size {d}; "
            "pad the matrix first (pad_rows_to_multiple)"
        )
    rows_per = n // d
    views = all(dev == mat.device for dev in mesh.devices.flat)
    placed: dict[tuple, torch.Tensor] = {}
    blocks = []
    for p in range(mesh.devices.shape[0]):
        row = []
        for r in range(d):
            dev = mesh.devices[p, r]
            if (dev, r) not in placed:
                blk = mat[r * rows_per: (r + 1) * rows_per]
                placed[(dev, r)] = blk if views else blk.to(dev, copy=True)
            row.append(placed[(dev, r)])
        blocks.append(row)
    return blocks


def chunk_shards(mesh: Mesh, C: int,
                 ring: bool) -> list[tuple[int, int, slice]]:
    """How a chunk of ``C`` permutations splits over the mesh, as ``(p, r,
    slice)`` in shard order; ``C`` is a multiple of the shard count
    (``PermutationEngine.effective_chunk``).

    - ``ring``: over perm × row. Shard ``(p, r)`` takes the contiguous
      slice ``p * R + r`` of ``C / (P * R)`` permutations: the major-to-minor
      order in which the JAX package's ``ring_chunk_specs``
      (``P((perm, row))``) and ``shard_chunk_offset`` split the chunk.
    - otherwise over perm only: perm shard ``p`` takes slice ``p`` of ``C /
      P`` and runs on ``mesh.devices[p, 0]`` (``r`` is 0).

    Outputs go back in the same order, so the same seed gives the same
    permutation at every mesh shape."""
    P = mesh.shape[PERM_AXIS]
    R = mesh.shape[ROW_AXIS] if ring else 1
    per = C // (P * R)
    return [(p, r, slice((p * R + r) * per, (p * R + r + 1) * per))
            for p in range(P) for r in range(R)]


def _psum_gather(blocks_row, idx_list, dev) -> list:
    """``M[idx][:, idx]`` on ``dev`` for every index tensor of ``idx_list``
    from one perm shard's row blocks (they cover every row): in place,
    one launch per block, where every block lies on ``dev``; else each
    block's share, summed on ``dev``."""
    rows_per = blocks_row[0].shape[0]
    if all(blk.device == dev for blk in blocks_row):
        idx_list = [ix.to(dev) for ix in idx_list]
        out = [torch.empty(ix.shape + ix.shape[-1:], dtype=torch.float32,
                           device=dev) for ix in idx_list]
        for r, blk in enumerate(blocks_row):
            gather_submatrix_fused_many(blk, idx_list, r * rows_per, out=out)
        return out
    total = None
    for r, blk in enumerate(blocks_row):
        parts = [p.to(dev) for p in gather_submatrix_fused_many(
            blk, [ix.to(blk.device) for ix in idx_list], r * rows_per)]
        total = parts if total is None else [
            t.add_(p) for t, p in zip(total, parts)]
    return total


def gather_corr_net(gather, tc, tn, idx_list, net_beta):
    """One dispatch point for derived-network mode over a sharded
    gatherer: with ``tn`` present gather the (corr, net) submatrix lists;
    with ``tn`` None gather only the correlations and derive each network
    from them with :func:`~netrep_tpu_torch.ops.stats.derived_net`
    (``net_beta`` is ``EngineConfig.network_from_correlation``)."""
    if tn is not None:
        return gather(tc, tn, idx_list)
    sub_c = gather(tc, None, idx_list)
    return sub_c, [tstats.derived_net(s, net_beta) for s in sub_c]


def make_sharded_gatherer(mesh: Mesh):
    """A batched gather over row-sharded correlation/network matrices:
    ``gather(corr, net, idx_list)`` with ``corr``/``net`` as
    :func:`shard_rows` gives them (``net`` may be None: only the
    correlation is gathered and its list returned alone). ``idx_list``
    holds one ``(..., m)`` index tensor per bucket; each ``(..., m, m)``
    result is assembled from perm shard 0's blocks on ``mesh.devices[0,
    0]``, every bucket in one launch per block and matrix — the engine
    hands each perm shard the one-row mesh of its own blocks
    (``Mesh.perm_row``).

    Every block's rows come from the gather kernel's wrapper: the JAX
    package's ``'direct'`` and ``'fused'`` modes are both exact copies, and
    so is the kernel (``EngineConfig`` refuses ``'mxu'``)."""

    def gather(corr, net, idx_list):
        out = [_psum_gather(m[0], idx_list, mesh.devices[0, 0])
               for m in ([corr] if net is None else [corr, net])]
        return out[0] if net is None else tuple(out)

    return gather
