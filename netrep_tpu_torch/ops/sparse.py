"""Sparse-adjacency statistics — the Config E path (a 50,000-cell kNN
graph, sparse adjacency, Leiden-cluster modules).

The port of ``netrep_tpu/ops/sparse.py``, with the same representation
and semantics:

- **Padded neighbour lists.** A graph is ``nbr (n, k)`` neighbour ids and
  ``wgt (n, k)`` weights, each row padded to the largest degree with the
  sentinel id ``n`` and weight 0 (:class:`SparseAdjacency`, a host numpy
  class copied from the JAX package).
- **Membership by sort + searchsorted.** Per (permutation, module) the
  module's valid ids are sorted (padded slots keyed to the int32 maximum,
  so they sort last) and every gathered neighbour id is binary-searched
  among them: ``O(m·k)`` work per instance, no ``n``-length mask.
- **Correlation on the fly, or precomputed sparse.** No ``n × n`` matrix
  exists: a module's correlation submatrix is ``zᵀz/(s-1)`` of its
  gathered, standardized data slice (:func:`corr_from_zdata`), or, when
  the user gives a precomputed sparse correlation in the same format, a
  membership scatter out of it (:func:`scatter_corr_submatrix`). Without
  data a precomputed correlation keeps four statistics finite
  (avg.weight, cor.cor, cor.degree, avg.cor); with neither, only
  avg.weight and cor.degree.

Where the JAX package maps one module with ``vmap``, each function here
takes leading ``(permutation, module)`` axes on its index arguments and
broadcasts them against the ``(module, …)`` discovery properties. The
data matrix is held TRANSPOSED, ``(n, s)``, so a module's data slice is a
gather of rows (:func:`~netrep_tpu_torch.ops.stats.gather_zdata`); the
values are those of the JAX package's column gather.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import stats as tstats
from .stats import DiscProps, _f32

_EPS = 1e-30
#: key of a padded module slot in the sorted id list: past every node id
_BIG = int(np.iinfo(np.int32).max)


@dataclasses.dataclass(frozen=True)
class SparseAdjacency:
    """Symmetric sparse adjacency as padded neighbour lists. ``nbr[i]``
    holds the neighbour ids of node ``i`` padded with the sentinel ``n``;
    ``wgt[i]`` the matching edge weights padded with 0. Self-loops are
    dropped on construction (the statistics exclude the diagonal)."""

    nbr: np.ndarray   # (n, k) int32
    wgt: np.ndarray   # (n, k) float32
    n: int

    @property
    def k(self) -> int:
        return self.nbr.shape[1]

    @property
    def nnz(self) -> int:
        return int((self.wgt != 0).sum())

    @classmethod
    def from_arrays(cls, nbr, wgt, n: int) -> "SparseAdjacency":
        """An adjacency from its arrays as another package holds them (for
        instance the JAX package's ``SparseAdjacency.nbr``/``wgt``/``n``):
        ``nbr`` ``(n, k)`` int32 ids in ``[0, n]``, ``wgt`` ``(n, k)``
        float32, every slot holding the sentinel ``n`` weighted 0. The
        arrays are copied as they are, after these checks."""
        nbr, wgt, n = np.asarray(nbr), np.asarray(wgt), int(n)
        if nbr.ndim != 2 or nbr.shape != wgt.shape or nbr.shape[0] != n:
            raise ValueError(
                f"nbr and wgt must both be ({n}, k), got {nbr.shape} and "
                f"{wgt.shape}"
            )
        if nbr.dtype != np.int32 or wgt.dtype != np.float32:
            raise ValueError(
                f"nbr must be int32 and wgt float32, got {nbr.dtype} and "
                f"{wgt.dtype}"
            )
        if nbr.size and (nbr.min() < 0 or nbr.max() > n):
            raise ValueError(f"neighbor ids out of range for n={n}")
        if (wgt[nbr == n] != 0).any():
            raise ValueError(
                f"padded slots (id {n}) must carry weight 0"
            )
        return cls(nbr=nbr.copy(), wgt=wgt.copy(), n=n)

    @classmethod
    def from_coo(cls, rows, cols, vals, n: int,
                 symmetrize: bool = True) -> "SparseAdjacency":
        """Build from COO triplets. ``symmetrize=True`` (default) unions
        the edge set with its transpose — pass each undirected edge once or
        in both directions. Duplicate entries for the same undirected edge
        (in either orientation) resolve to the LAST one in input order, on
        the canonical ``(min(i,j), max(i,j))`` edge before mirroring, so
        both directions agree even when conflicting reciprocal entries are
        given. With ``symmetrize=False`` the input must already hold both
        directions of every edge; per-direction duplicates resolve
        last-wins."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        if rows.shape != cols.shape or rows.shape != vals.shape:
            raise ValueError("rows/cols/vals must have identical shapes")
        if rows.size and (rows.min() < 0 or rows.max() >= n
                          or cols.min() < 0 or cols.max() >= n):
            raise ValueError(f"COO indices out of range for n={n}")
        keep = (rows != cols) & (vals != 0)
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        if symmetrize:
            # a stable sort keeps input order within each canonical edge,
            # so the last occurrence wins whatever its orientation
            lo, hi = np.minimum(rows, cols), np.maximum(rows, cols)
            order = np.lexsort((hi, lo))
            lo, hi, vals = lo[order], hi[order], vals[order]
            last = np.ones(lo.size, dtype=bool)
            if lo.size > 1:
                last[:-1] = (lo[:-1] != lo[1:]) | (hi[:-1] != hi[1:])
            lo, hi, vals = lo[last], hi[last], vals[last]
            rows, cols = np.concatenate([lo, hi]), np.concatenate([hi, lo])
            vals = np.concatenate([vals, vals])
        # dedupe (i, j): later entries overwrite earlier
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        uniq = np.ones(rows.size, dtype=bool)
        if rows.size > 1:
            uniq[:-1] = (rows[:-1] != rows[1:]) | (cols[:-1] != cols[1:])
        rows, cols, vals = rows[uniq], cols[uniq], vals[uniq]

        counts = np.bincount(rows, minlength=n)
        k = max(int(counts.max(initial=0)), 1)
        nbr = np.full((n, k), n, dtype=np.int32)
        wgt = np.zeros((n, k), dtype=np.float32)
        # rows are sorted, so each row's entries are consecutive: entry t
        # goes to slot t - start(row)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(rows.size) - starts[rows]
        nbr[rows, slot] = cols
        wgt[rows, slot] = vals
        return cls(nbr=nbr, wgt=wgt, n=n)

    @classmethod
    def from_dense(cls, mat, tol: float = 0.0) -> "SparseAdjacency":
        """Sparsify a dense symmetric adjacency (|entry| > tol kept)."""
        mat = np.asarray(mat, dtype=np.float64)
        if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
            raise ValueError(f"adjacency must be square, got {mat.shape}")
        if not np.allclose(mat, mat.T, atol=1e-8):
            raise ValueError("adjacency must be symmetric")
        rows, cols = np.nonzero(np.abs(mat) > tol)
        return cls.from_coo(rows, cols, mat[rows, cols], mat.shape[0],
                            symmetrize=False)

    @classmethod
    def from_scipy(cls, mat, symmetrize: bool = True) -> "SparseAdjacency":
        """Build from any ``scipy.sparse`` matrix (single-cell kNN graphs,
        e.g. ``adata.obsp['connectivities']``). Duplicate entries are
        summed first, as scipy reads them; directed graphs are symmetrized
        by default (:meth:`from_coo`)."""
        from scipy import sparse as sp

        if not sp.issparse(mat):
            raise TypeError(
                "from_scipy takes a scipy.sparse matrix, got "
                f"{type(mat).__name__}"
            )
        if mat.shape[0] != mat.shape[1]:
            raise ValueError(f"adjacency must be square, got {mat.shape}")
        coo = mat.tocoo()
        coo.sum_duplicates()
        return cls.from_coo(coo.row, coo.col, coo.data, mat.shape[0],
                            symmetrize=symmetrize)

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n, self.n), dtype=np.float64)
        rows = np.repeat(np.arange(self.n), self.k)
        cols = self.nbr.reshape(-1)
        vals = self.wgt.reshape(-1).astype(np.float64)
        keep = cols < self.n
        out[rows[keep], cols[keep]] = vals[keep]
        return out


# ---------------------------------------------------------------------------
# Statistics on gathered neighbour rows (leading batch axes)
# ---------------------------------------------------------------------------

def _membership(nbr_rows, idx, w, stable: bool = False):
    """``(sidx, order, pos)``: the module's ids keyed and sorted (padded
    slots last), the sort order (``stable``: ties in input order, as
    ``jnp.argsort``), and for every neighbour id of ``nbr_rows`` ``(...,
    m, k)`` the clipped ``searchsorted`` position among them. The ids go
    to int64 together, so ``searchsorted`` sees one type; each instance's
    ``(m·k)`` queries are flattened against its own ``(m,)`` sequence."""
    m = idx.shape[-1]
    keyed = torch.where(w > 0, idx.long(), _BIG)
    sidx, order = torch.sort(keyed, dim=-1, stable=stable)
    q = nbr_rows.long()
    lead = torch.broadcast_shapes(sidx.shape[:-1], q.shape[:-2])
    sidx = sidx.expand(lead + (m,)).contiguous()
    order = order.expand(lead + (m,))
    flat = q.expand(lead + q.shape[-2:]).reshape(lead + (-1,))
    pos = torch.searchsorted(sidx, flat).clamp_(0, m - 1)
    return sidx, order, pos, q.expand(lead + q.shape[-2:])


def sparse_module_topology(nbr_rows, wgt_rows, idx, w):
    """Within-module average edge weight and weighted degree from padded
    neighbour lists: ``nbr_rows``/``wgt_rows`` ``(..., m, k)`` the module
    nodes' gathered rows, ``idx`` ``(..., m)`` its padded node ids, ``w``
    ``(..., m)`` the 0/1 mask. Equals the dense statistics on the densified
    graph: the denominator is all ordered valid pairs ``m·(m-1)``."""
    sidx, _order, pos, q = _membership(nbr_rows, idx, w)
    hit = torch.gather(sidx, -1, pos).reshape(q.shape)
    member = (hit == q) & (q != idx.long()[..., None])
    w = _f32(w)
    mw = _f32(wgt_rows) * member * w[..., None]
    degree = mw.sum(-1) * w
    mv = w.sum(-1)
    avg_weight = degree.sum(-1) / torch.clamp(mv * (mv - 1.0), min=_EPS)
    return avg_weight, degree


def scatter_corr_submatrix(nbr_rows, wgt_rows, idx, w) -> torch.Tensor:
    """Module-order ``(..., m, m)`` correlation submatrix out of a
    PRECOMPUTED sparse correlation in neighbour-list format: member hits
    are added at their module-order columns (rank → position through the
    stable argsort), absent pairs stay 0. A non-member's write goes to an
    extra column ``m`` that is then cut off (JAX's ``mode="drop"`` at index
    ``m``). Multiplied by the off-diagonal pair mask."""
    m = idx.shape[-1]
    sidx, order, pos, q = _membership(nbr_rows, idx, w, stable=True)
    hit = torch.gather(sidx, -1, pos).reshape(q.shape)
    member = (hit == q) & (q != idx.long()[..., None]) & (w[..., None] > 0)
    cols = torch.gather(order, -1, pos).reshape(q.shape)
    cols = torch.where(member, cols, m)
    vals = torch.where(member, _f32(wgt_rows), 0.0)
    sub = torch.zeros(q.shape[:-1] + (m + 1,), dtype=torch.float32,
                      device=q.device)
    sub.scatter_add_(-1, cols, vals)
    return sub[..., :m] * tstats.offdiag_mask(w)


def corr_from_zdata(zdata, n_samples: int, w) -> torch.Tensor:
    """Exact Pearson correlation submatrix of a standardized (ddof=1)
    masked data slice ``(..., s, m)``: ``zᵀz/(s-1)``, multiplied by the
    off-diagonal pair mask (the form ``stats_from_parts`` takes). The
    on-the-fly replacement for gathering from an ``n × n`` matrix."""
    corr = (zdata.transpose(-1, -2) @ zdata) / max(n_samples - 1, 1)
    return corr * tstats.offdiag_mask(w)


def sparse_gather_and_stats(disc: DiscProps, idx, nbr, wgt, test_dataT,
                            corr_nbr=None, corr_wgt=None, n_iter: int = 60,
                            summary_method: str = "power") -> torch.Tensor:
    """The seven statistics of padded test node sets ``idx`` ``(..., m)``
    on a sparse network — the sparse counterpart of
    :func:`~netrep_tpu_torch.ops.stats.gather_and_stats`. Gathers
    ``O(m·k)`` adjacency rows and (optionally) an ``(s, m)`` data slice of
    the transposed ``(n, s)`` data, nothing ``O(n²)``. Padded slots may
    hold any in-range id (they read row 0 and are masked).

    A precomputed sparse correlation (``corr_nbr``/``corr_wgt``) feeds
    the correlation statistics when given; otherwise they come from the
    data on the fly; with neither they are NaN. With a precomputed
    correlation and no data, ``avg.cor`` (index 5) is computed too: its
    inputs are correlations only."""
    w = disc.mask
    safe = torch.where(w > 0, idx.long(), 0)
    avg_weight, degree = sparse_module_topology(nbr[safe], wgt[safe], idx, w)
    zdata = (None if test_dataT is None
             else tstats.gather_zdata(test_dataT, safe, w))
    if corr_nbr is not None:
        corr = scatter_corr_submatrix(corr_nbr[safe], corr_wgt[safe], idx, w)
    elif zdata is not None:
        corr = corr_from_zdata(zdata, test_dataT.shape[-1], w)
    else:
        corr = None
    out = tstats.stats_from_parts(disc, avg_weight, degree, corr, zdata,
                                  n_iter=n_iter,
                                  summary_method=summary_method)
    if corr is not None and zdata is None:
        pair = tstats.offdiag_mask(w)
        npair = torch.clamp(pair.sum((-1, -2)), min=_EPS)
        out[..., 5] = (disc.sign_corr * corr).sum((-1, -2)) / npair
    return out


def make_disc_props_sparse(adj_nbr, adj_wgt, dataT, idx_pad, mask,
                           corr_nbr=None, corr_wgt=None,
                           summary_method: str = "eigh") -> DiscProps:
    """Discovery-side fixed properties of a bucket of modules ``idx_pad``
    ``(K, cap)`` on a sparse discovery network: degree from the neighbour
    lists, the correlation submatrix from the precomputed sparse
    correlation when given, else from the data slice of the transposed
    ``(n, s)`` data ``dataT`` (zero without either), node contributions
    from the data. Runs once per pair, outside the null."""
    w = _f32(mask)
    safe = torch.where(w > 0, idx_pad.long(), 0)
    _avg, degree = sparse_module_topology(adj_nbr[safe], adj_wgt[safe],
                                          idx_pad, w)
    if dataT is not None:
        sub = dataT[safe].transpose(-1, -2)              # (K, s, cap)
        zdata = tstats.standardize_masked(sub, w)
        prof = tstats.summary_profile_masked(zdata, w, method=summary_method)
        contrib = tstats.node_contribution_masked(zdata, prof, w)
    else:
        zdata = None
        contrib = torch.zeros_like(degree)
    if corr_nbr is not None:
        corr = scatter_corr_submatrix(corr_nbr[safe], corr_wgt[safe],
                                      idx_pad, w)
    elif zdata is not None:
        corr = corr_from_zdata(zdata, dataT.shape[-1], w)
    else:
        corr = torch.zeros(idx_pad.shape + idx_pad.shape[-1:],
                           dtype=torch.float32, device=w.device)
    return DiscProps(corr=corr, sign_corr=torch.sign(corr), degree=degree,
                     contrib=contrib, sign_contrib=torch.sign(contrib),
                     mask=w)
